"""PyTorch + CUDA port of synchformer_tpu for NVIDIA Hopper.

The sync-inference path (log-mel, AST and Motionformer towers, the
GlobalTransformer) with the four TPU kernels of that path written by hand in
CUDA C++ under csrc/. Entry point: ``synchformer_tpu_torch.infer.SyncPredictor``.
"""
