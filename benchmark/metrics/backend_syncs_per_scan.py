"""Host syncs per window scan inside the back end (``loop_closure.verify``,
``graph.solve`` and the spans under them): the program's counted host reads
(``host_syncs`` by span) and the syncs PyTorch made on its own, each tagged
with the program span open when it was made (``yardstick/layers.py``)."""
from yardstick import layers


def read(ctx):
    return layers.syncs_per_scan(ctx.profiled, layers.BACKEND)
