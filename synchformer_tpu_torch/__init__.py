"""PyTorch + CUDA port of synchformer_tpu for NVIDIA Hopper.

Three paths, with the TPU kernels they run written by hand in CUDA C++ under
csrc/: sync inference (log-mel, AST and Motionformer towers, the
GlobalTransformer; ``synchformer_tpu_torch.infer.SyncPredictor``), the
Stage I contrastive training step of AVCLIP or MoCo
(``synchformer_tpu_torch.train.stage_clip.AVCLIPTrainer``), and the Stage
II/III training step over frozen towers
(``synchformer_tpu_torch.train.stage_sync.SyncTrainer``). Models and
datasets are built from the configs' target / params nodes by
``synchformer_tpu_torch.registry``. ``python -m synchformer_tpu_torch.main
config=<yaml>`` trains any stage from a config: the loader (``data/``), the
audio augmentations on the card (``ops/dsp.py``), the trainers' fit loops
with checkpoints and resume.
"""
