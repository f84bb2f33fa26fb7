"""h2d_ms.offline: stream milliseconds a batch in the predictor's input copy
(``predict.h2d`` of synchformer_tpu_torch/utils/trace.py: the pinned uint8
video, PCM and masks to the card, CUDA events around the copies) over the
traced units."""
from benchmark import program_trace


def read(ctx):
    return program_trace.stream_ms(ctx, ("predict.h2d",))
