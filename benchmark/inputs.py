"""A cell's inputs from the run's seed: a pool of distinct batches, made on
the device with a seeded generator in a few large calls and held in pinned
host memory in the layout the port's loader hands its entry, so that each
use copies its batch to the card as a served or trained batch would come.

- ``frames``: uint8 frames (B, S, T, H, W, 3), the trainers' layout, each
  clip at its own brightness and contrast;
  ``patches``: the same frames patch-major (B, S, T // z, n, z * p * p * 3),
  the layout the predictor takes.
- ``audio``: PCM (B, S, L), each clip at its own loudness (standard
  deviation log-uniform in 0.03 to 0.3).
- ``offset_target``: integer offset classes (B,), Stage II's targets.

The same seed gives the same pool; no two batches share a row.
"""
from __future__ import annotations

import torch

INPUT_SEED_OFFSET = 0x1A7A


def make_pool(sizes: dict, traffic: dict, seed: int, device) -> list:
    """``traffic['pool']`` batches of ``traffic['batch']`` clips with the
    fields ``traffic['fields']`` names."""
    v, a = sizes["video"], sizes["audio"]
    b, seg = traffic["batch"], sizes["segments"]
    g = torch.Generator(device=device).manual_seed(int(seed) + INPUT_SEED_OFFSET)
    pin = torch.device(device).type == "cuda"
    pool = []
    for _ in range(traffic["pool"]):
        batch = {}
        frames = _frames(g, (b, seg, v["frames"], v["img"], v["img"], 3), device)
        if "patches" in traffic["fields"]:
            batch["patches"] = patchify(frames, v["z"], v["patch"])
        if "frames" in traffic["fields"]:
            batch["frames"] = frames
        loud = 10.0 ** torch.empty((b, 1, 1), device=device).uniform_(-1.5, -0.5, generator=g)
        batch["audio"] = torch.randn((b, seg, a["pcm_len"]), generator=g,
                                     device=device).mul_(loud)
        if "offset_target" in traffic["fields"]:
            batch["offset_target"] = torch.randint(0, sizes["transformer"]["num_cls"], (b,),
                                                   generator=g, device=device)
        pool.append({k: _host(t, pin) for k, t in batch.items()})
        del frames, batch
    return pool


def _frames(g: torch.Generator, shape, device) -> torch.Tensor:
    """uint8 frames, each clip its own brightness (64 to 192) and contrast
    (noise of half-width 60 to 127), so that clips differ in what the towers
    see and not only in their noise. (Clips of little contrast give the
    segments near-identical features, on which the contrastive loss turns
    every rounding into a large change.)"""
    b = shape[0]
    lead = (b,) + (1,) * (len(shape) - 1)
    base = torch.empty(lead, device=device).uniform_(64.0, 192.0, generator=g)
    spread = torch.empty(lead, device=device).uniform_(60.0, 127.0, generator=g)
    noise = torch.rand(shape, generator=g, device=device).mul_(2.0).sub_(1.0)
    return noise.mul_(spread).add_(base).round_().clamp_(0.0, 255.0).to(torch.uint8)


def _host(t: torch.Tensor, pin: bool) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    out.copy_(t)
    return out


def patchify(x: torch.Tensor, z: int, p: int) -> torch.Tensor:
    """(..., T, H, W, C) -> (..., T // z, (H // p) * (W // p), z * p * p * C),
    contiguous, each patch in (z, ph, pw, c) order."""
    *lead, t, h, w, c = x.shape
    x = x.reshape(*lead, t // z, z, h // p, p, w // p, p, c)
    k = len(lead)
    x = x.permute(*range(k), *(i + k for i in (0, 2, 4, 1, 3, 5, 6)))
    return x.reshape(*lead, t // z, (h // p) * (w // p), z * p * p * c).contiguous()


def to_device(batch: dict, device) -> dict:
    return {k: t.to(device, non_blocking=True) for k, t in batch.items()}
