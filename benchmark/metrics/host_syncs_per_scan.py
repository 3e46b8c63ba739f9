"""Host syncs per window scan: the program's counted host reads
(``RunResult.host_syncs``) plus the syncs PyTorch made on its own, as
``torch.cuda.set_sync_debug_mode("warn")`` reports them (stream and event
synchronizes left out: the step timer's and the benchmark's own)."""


def read(ctx):
    ctx = ctx.profiled  # the traced window
    if ctx is None or ctx.implicit_syncs is None or ctx.n == 0:
        return None
    n = ctx.n
    return (sum(ctx.host_syncs[:n]) + sum(ctx.implicit_syncs[:n])) / n
