"""prepare_ms.train: stream milliseconds a step in the trainer's input
preparation (``step.prepare`` of synchformer_tpu_torch/utils/trace.py: the
uint8 frames and PCM copied to the card, the flip, the normalisation, the
patchify, the log-mel, Stage II's targets), CUDA events around it, over the
traced units."""
from benchmark import program_trace


def read(ctx):
    return program_trace.stream_ms(ctx, ("step.prepare",))
