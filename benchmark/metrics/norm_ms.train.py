"""norm_ms.train: stream milliseconds a step in the towers' LayerNorm and cast
compositions outside the kernel wrappers (every ``norm`` span of
synchformer_tpu_torch/utils/trace.py, in the forward and in a remat
recompute), CUDA events around each, over the traced units."""
from benchmark import program_trace


def read(ctx):
    return program_trace.stream_ms(ctx, ("norm",))
