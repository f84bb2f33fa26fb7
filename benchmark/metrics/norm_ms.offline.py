"""norm_ms.offline: stream milliseconds a batch in the towers' LayerNorm and
cast compositions outside the kernel wrappers (every ``norm`` span of
synchformer_tpu_torch/utils/trace.py: norm3 / norm1 of the CLS row and the
patches, the final norms, the pre-LN blocks' LayerNorm before the
attention), CUDA events around each, over the traced units."""
from benchmark import program_trace


def read(ctx):
    return program_trace.stream_ms(ctx, ("norm",))
