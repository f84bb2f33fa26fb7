"""PyTorch + CUDA port of synchformer_tpu for NVIDIA Hopper.

Two paths, with the TPU kernels they run written by hand in CUDA C++ under
csrc/: sync inference (log-mel, AST and Motionformer towers, the
GlobalTransformer; ``synchformer_tpu_torch.infer.SyncPredictor``) and the
Stage I contrastive training step of AVCLIP
(``synchformer_tpu_torch.train.stage_clip.AVCLIPTrainer``).
"""
