"""idle_dispatch_ms.train: device idle milliseconds a step while the host
dispatches the model: each gap between the union of the kernels' intervals
(torch.profiler; user annotations, which have a host twin of their name, and
copies left out) whose middle falls, on the profiler's clock, in a program
span under ``step.forward``, ``step.backward`` or ``step.update``
(synchformer_tpu_torch/utils/trace.py), over the traced units. The traced
units run under the profiler, whose per-op callbacks slow the host: host-bound
phases read high."""
from benchmark import program_trace


def read(ctx):
    return program_trace.idle_ms(ctx, dispatch=True)
