"""idle_boundary_ms.train: device idle milliseconds a step outside the
model's dispatch: each gap between the union of the kernels' intervals
(torch.profiler; user annotations, which have a host twin of their name, and
copies left out) whose middle falls, on the profiler's clock, in
``step.prepare``, in ``step.metrics_sync``, between a step's phases or in no
step (synchformer_tpu_torch/utils/trace.py), over the traced units. With
idle_dispatch_ms.train it sums every gap between the first and the last
kernel. The traced units run under the profiler, whose per-op callbacks slow
the host: host-bound phases read high."""
from benchmark import program_trace


def read(ctx):
    return program_trace.idle_ms(ctx, dispatch=False)
