"""host_syncs.train: host-device synchronisations a step that the program
forces (the ``host_syncs`` counter of synchformer_tpu_torch/utils/trace.py,
counted at each site: ``.item()``, a blocking copy between host and card)
over the traced units."""
from benchmark import program_trace


def read(ctx):
    return program_trace.counter(ctx, "host_syncs")
