"""Host syncs per window scan inside scan-to-map (``scan_to_map.refine`` and
the spans under it): the program's counted host reads (``host_syncs`` by
span) and the syncs PyTorch made on its own, each tagged with the program
span open when it was made (``yardstick/layers.py``)."""
from yardstick import layers


def read(ctx):
    return layers.syncs_per_scan(ctx.profiled, layers.SCAN_TO_MAP)
