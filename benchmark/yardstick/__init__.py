"""The benchmark's yardstick: the parts that later changes to the system
cannot move (traffic, timeline and trace arithmetic, the bytes of a kernel
call, the import check, the comparison that decides ``correct``) and the
drive that runs the system under test (``drive.py``)."""
