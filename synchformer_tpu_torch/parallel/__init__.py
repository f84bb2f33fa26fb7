"""Data-parallel training over torch.distributed ranks (see ``dist``)."""
