"""The plain reference of the Synchformer family: the sync model's forward
(configs/sync.yaml), the Stage I AVCLIP step (configs/segment_avclip.yaml)
and the Stage II step, in plain PyTorch over a dict of f32 tensors named
as the published state dicts name them.

It imports nothing of the measured program. It follows the published
description (Synchformer, Iashin et al. 2024; Motionformer's divided
space-time blocks; the AST; the CLS-pool aggregators; the minGPT offset
transformer) and the numerics of its configurations in float32, with
TensorFloat-32 off. ``Numerics("fp8")`` is the control: every matrix
product's operands, forward and backward, rounded to float8 e4m3 with a
per-tensor scale, the step below the bf16 the configurations state.

Weights and the masks a training step draws are worked out again from the
seed: ``make_weights`` draws the same tensors the benchmark hands the
program, and the training references draw flips, drop-path factors and
dropout masks from a generator seeded as the program's step generator, in
the order its step draws them (frame flips, then per Motionformer block the
space and MLP drop-path factors; or, in Stage II, the flips, then the
embedding dropout and per block the attention, projection, MLP hidden and
MLP output dropouts).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 value

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# numerics


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (its amax to 448)."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        return _unbroadcast(ga, qa.shape), _unbroadcast(gb, qb.shape)


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    while g.ndim > len(shape):
        g = g.sum(0)
    for i, s in enumerate(shape):
        if s == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class Numerics:
    """'f32': every product in float32; 'fp8': the control."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"numerics {mode!r}: 'f32' or 'fp8'")
        self.mode = mode

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            return _Fp8MatMul.apply(a, b)
        return torch.matmul(a, b)

    def linear(self, x, w, b=None):
        y = self.matmul(x, w.t())
        return y if b is None else y + b


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


# ---------------------------------------------------------------------------
# sizes and weights


def _cls_pool_spec(prefix: str, d: int, hidden: int) -> list:
    return [(f"{prefix}.cls_token", (1, 1, d)),
            (f"{prefix}.norm1.weight", (d,)), (f"{prefix}.norm1.bias", (d,)),
            (f"{prefix}.norm2.weight", (d,)), (f"{prefix}.norm2.bias", (d,)),
            (f"{prefix}.self_attn.in_proj_weight", (3 * d, d)),
            (f"{prefix}.self_attn.in_proj_bias", (3 * d,)),
            (f"{prefix}.self_attn.out_proj.weight", (d, d)),
            (f"{prefix}.self_attn.out_proj.bias", (d,)),
            (f"{prefix}.linear1.weight", (hidden, d)), (f"{prefix}.linear1.bias", (hidden,)),
            (f"{prefix}.linear2.weight", (d, hidden)), (f"{prefix}.linear2.bias", (d,))]


def _video_spec(v: dict, d: int) -> list:
    hid = int(d * v["mlp_ratio"])
    n = (v["img"] // v["patch"]) ** 2
    f = v["frames"] // v["z"]
    p = "vfeat_extractor"
    spec = [(f"{p}.cls_token", (1, 1, d)), (f"{p}.pos_embed", (1, n + 1, d)),
            (f"{p}.temp_embed", (1, f, d)),
            (f"{p}.patch_embed_3d.proj.weight", (d, 3, v["z"], v["patch"], v["patch"])),
            (f"{p}.patch_embed_3d.proj.bias", (d,))]
    for i in range(v["depth"]):
        b = f"{p}.blocks.{i}"
        for nm in ("norm1", "norm2", "norm3"):
            spec += [(f"{b}.{nm}.weight", (d,)), (f"{b}.{nm}.bias", (d,))]
        for at in ("attn", "timeattn"):
            spec += [(f"{b}.{at}.qkv.weight", (3 * d, d)), (f"{b}.{at}.qkv.bias", (3 * d,)),
                     (f"{b}.{at}.proj.weight", (d, d)), (f"{b}.{at}.proj.bias", (d,))]
        spec += [(f"{b}.mlp.fc1.weight", (hid, d)), (f"{b}.mlp.fc1.bias", (hid,)),
                 (f"{b}.mlp.fc2.weight", (d, hid)), (f"{b}.mlp.fc2.bias", (d,))]
    spec += [(f"{p}.norm.weight", (d,)), (f"{p}.norm.bias", (d,))]
    return spec + _cls_pool_spec(f"{p}.spatial_attn_agg", d, hid)


def _audio_spec(a: dict, d: int) -> list:
    hid = int(d * a["mlp_ratio"])
    ft = _ast_grid(a)
    p = "afeat_extractor"
    e = f"{p}.ast.embeddings"
    spec = [(f"{e}.cls_token", (1, 1, d)), (f"{e}.distillation_token", (1, 1, d)),
            (f"{e}.position_embeddings", (1, 2 + ft[0] * ft[1], d)),
            (f"{e}.patch_embeddings.projection.weight", (d, 1, a["patch"], a["patch"])),
            (f"{e}.patch_embeddings.projection.bias", (d,))]
    for i in range(a["depth"]):
        b = f"{p}.ast.encoder.layer.{i}"
        spec += [(f"{b}.layernorm_before.weight", (d,)), (f"{b}.layernorm_before.bias", (d,)),
                 (f"{b}.layernorm_after.weight", (d,)), (f"{b}.layernorm_after.bias", (d,))]
        for nm in ("query", "key", "value"):
            spec += [(f"{b}.attention.attention.{nm}.weight", (d, d)),
                     (f"{b}.attention.attention.{nm}.bias", (d,))]
        spec += [(f"{b}.attention.output.dense.weight", (d, d)),
                 (f"{b}.attention.output.dense.bias", (d,)),
                 (f"{b}.intermediate.dense.weight", (hid, d)),
                 (f"{b}.intermediate.dense.bias", (hid,)),
                 (f"{b}.output.dense.weight", (d, hid)), (f"{b}.output.dense.bias", (d,))]
    spec += [(f"{p}.ast.layernorm.weight", (d,)), (f"{p}.ast.layernorm.bias", (d,))]
    return spec + _cls_pool_spec(f"{p}.freq_attn_agg", d, hid)


def _transformer_spec(t: dict, d: int, seq_len: int) -> list:
    hid = int(d * t["mlp_ratio"])
    p = "transformer"
    spec = [(f"{p}.OFF_tok", (1, 1, d)), (f"{p}.MOD_tok", (1, 1, d)),
            (f"{p}.vis_in_lnorm.weight", (d,)), (f"{p}.vis_in_lnorm.bias", (d,)),
            (f"{p}.aud_in_lnorm.weight", (d,)), (f"{p}.aud_in_lnorm.bias", (d,)),
            (f"{p}.pos_emb_cfg.pos_emb", (1, seq_len, d))]
    for i in range(t["n_layer"]):
        b = f"{p}.blocks.{i}"
        spec += [(f"{b}.ln1.weight", (d,)), (f"{b}.ln1.bias", (d,)),
                 (f"{b}.ln2.weight", (d,)), (f"{b}.ln2.bias", (d,))]
        for nm in ("query", "key", "value", "proj"):
            spec += [(f"{b}.attn.{nm}.weight", (d, d)), (f"{b}.attn.{nm}.bias", (d,))]
        spec += [(f"{b}.mlp.0.weight", (hid, d)), (f"{b}.mlp.0.bias", (hid,)),
                 (f"{b}.mlp.2.weight", (d, hid)), (f"{b}.mlp.2.bias", (d,))]
    return spec + [(f"{p}.ln_f.weight", (d,)), (f"{p}.ln_f.bias", (d,)),
                   (f"{p}.off_head.weight", (t["num_cls"], d)),
                   (f"{p}.off_head.bias", (t["num_cls"],))]


def _ast_grid(a: dict) -> Tuple[int, int]:
    return ((a["n_mels"] - a["patch"]) // a["stride"] + 1,
            (a["max_spec_t"] - a["patch"]) // a["stride"] + 1)


def seq_len(s: dict) -> int:
    """The offset transformer's tokens: OFF, MOD and each segment's frames
    and audio time steps."""
    v, a = s["video"], s["audio"]
    return 2 + s["segments"] * (v["frames"] // v["z"] + _ast_grid(a)[1])


def param_spec(sizes: dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter of the model ``sizes`` describes
    (``kind`` 'sync': towers, projections and the offset transformer;
    'avclip': towers and the logit scale), in a fixed order."""
    d = sizes["d"]
    spec = _video_spec(sizes["video"], d) + _audio_spec(sizes["audio"], d)
    if sizes["kind"] == "avclip":
        return [("logit_scale", ())] + spec
    spec += [("vproj.weight", (d, d)), ("vproj.bias", (d,)),
             ("aproj.weight", (d, d)), ("aproj.bias", (d,))]
    return spec + _transformer_spec(sizes["transformer"], d, seq_len(sizes))


def _is_norm(name: str) -> bool:
    leaf = name.rsplit(".", 2)
    return len(leaf) >= 2 and (leaf[-2].startswith(("norm", "ln", "layernorm"))
                               or leaf[-2].endswith("lnorm"))


WEIGHT_SEED_OFFSET = 0x5EED


def make_weights(sizes: dict, seed: int, device) -> Params:
    """The configuration's weights from ``seed``, on ``device``, in f32: one
    draw of standard normals for every parameter at once (std 0.02), the
    LayerNorms at weight 1 and bias 0, an AVCLIP's logit scale at its
    ``init_scale``. The same seed gives the same tensors."""
    spec = param_spec(sizes)
    total = sum(math.prod(s) for _, s in spec)
    g = torch.Generator(device=device).manual_seed(int(seed) + WEIGHT_SEED_OFFSET)
    flat = torch.randn(total, generator=g, device=device).mul_(0.02)
    out, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if name == "logit_scale":
            t = torch.full(shape, float(sizes["init_scale"]), device=device)
        elif _is_norm(name):
            t = torch.full(shape, 1.0 if name.endswith("weight") else 0.0, device=device)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# the front ends


def patchify(x: torch.Tensor, z: int, p: int) -> torch.Tensor:
    """(..., T, H, W, C) -> (..., T // z, (H // p) * (W // p), z * p * p * C),
    each patch flattened in (z, ph, pw, c) order."""
    *lead, t, h, w, c = x.shape
    x = x.reshape(*lead, t // z, z, h // p, p, w // p, p, c)
    k = len(lead)
    x = x.permute(*range(k), *(i + k for i in (0, 2, 4, 1, 3, 5, 6)))
    return x.reshape(*lead, t // z, (h // p) * (w // p), z * p * p * c)


def normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> (x / 255 - 0.5) / 0.5 in f32."""
    return (x.float() / 255.0 - 0.5) / 0.5


MEL = dict(sample_rate=16000, n_fft=1024, win_length=400, hop_length=160, log_eps=1e-6,
           norm_mean=-4.2677393, norm_std=4.5689974)


def _mel_matrices(n_mels: int, device):
    n, k = MEL["n_fft"], MEL["n_fft"] // 2 + 1
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(MEL["win_length"]) / MEL["win_length"]))
    window = np.zeros(n)
    left = (n - MEL["win_length"]) // 2
    window[left:left + MEL["win_length"]] = win
    angle = 2.0 * np.pi * np.outer(np.arange(n), np.arange(k)) / n
    cos_m = np.cos(angle) * window[:, None]
    sin_m = -np.sin(angle) * window[:, None]
    sr = MEL["sample_rate"]
    freqs = np.linspace(0.0, sr / 2.0, k)
    mel_lo, mel_hi = (2595.0 * np.log10(1.0 + f / 700.0) for f in (0.0, sr / 2.0))
    pts = 700.0 * (10.0 ** (np.linspace(mel_lo, mel_hi, n_mels + 2) / 2595.0) - 1.0)
    diff = np.diff(pts)
    slopes = pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[None, :-1],
                                    slopes[:, 2:] / diff[None, 1:]))
    return tuple(torch.tensor(m, dtype=torch.float32, device=device)
                 for m in (cos_m, sin_m, fb))


def log_mel(pcm: torch.Tensor, n_mels: int, max_spec_t: int) -> torch.Tensor:
    """PCM (..., L) -> the AST's normalised log-mel (..., T, n_mels) in f32:
    Hann window 400, hop 160, n_fft 1024, HTK mels, power 2, centred with
    reflect padding, log(mel + 1e-6), padded or cut to ``max_spec_t``
    frames, (x - mean) / (2 std). The DFT in float64."""
    cos_m, sin_m, fb = _mel_matrices(n_mels, pcm.device)
    lead = pcm.shape[:-1]
    pad = MEL["n_fft"] // 2
    xp = F.pad(pcm.reshape(-1, 1, pcm.shape[-1]).float(), (pad, pad), mode="reflect")
    frames = xp[:, 0].unfold(-1, MEL["n_fft"], MEL["hop_length"]).double()
    re = frames @ cos_m.double()
    im = frames @ sin_m.double()
    mel = torch.log((re * re + im * im) @ fb.double() + MEL["log_eps"]).float()
    t = mel.shape[-2]
    mel = F.pad(mel, (0, 0, 0, max_spec_t - t)) if t < max_spec_t else mel[..., :max_spec_t, :]
    mel = (mel - MEL["norm_mean"]) / (2.0 * MEL["norm_std"])
    return mel.reshape(*lead, max_spec_t, n_mels)


# ---------------------------------------------------------------------------
# the layers


def _heads(x, h):
    return x.reshape(*x.shape[:-1], h, x.shape[-1] // h)


def attention(nm: Numerics, q, k, v, drop=None):
    """q (..., H, Lq, dh), k / v (..., H, Lk, dh) -> (..., H, Lq, dh);
    ``drop`` a keep-scale of the probabilities' shape or None."""
    logits = nm.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.softmax(logits, dim=-1)
    if drop is not None:
        p = p * drop
    return nm.matmul(p, v)


def mlp(nm, x, P, w1, w2, drops=(None, None)):
    h = gelu(nm.linear(x, P[f"{w1}.weight"], P[f"{w1}.bias"]))
    if drops[0] is not None:
        h = h * drops[0]
    out = nm.linear(h, P[f"{w2}.weight"], P[f"{w2}.bias"])
    return out if drops[1] is None else out * drops[1]


def cls_pool(nm, P, prefix: str, x, heads: int, eps: float = 1e-6):
    """(G, N, D) -> (G, D): the CLS row of one pre-LN encoder layer over
    [cls; x] (the CLS query over N + 1 keys; its MLP)."""
    g, n, d = x.shape
    cls = P[f"{prefix}.cls_token"].reshape(1, 1, d).expand(g, 1, d)
    xx = torch.cat([cls, x], dim=1)
    ln = layer_norm(xx, P[f"{prefix}.norm1.weight"], P[f"{prefix}.norm1.bias"], eps)
    w, b = P[f"{prefix}.self_attn.in_proj_weight"], P[f"{prefix}.self_attn.in_proj_bias"]
    q = nm.linear(ln[:, :1], w[:d], b[:d])
    kv = nm.linear(ln, w[d:], b[d:])
    q = _heads(q, heads).transpose(1, 2)
    k, v = (_heads(t, heads).transpose(1, 2) for t in kv.split(d, dim=-1))
    a = attention(nm, q, k, v).transpose(1, 2).reshape(g, 1, d)
    y = xx[:, :1] + nm.linear(a, P[f"{prefix}.self_attn.out_proj.weight"],
                              P[f"{prefix}.self_attn.out_proj.bias"])
    ln2 = layer_norm(y, P[f"{prefix}.norm2.weight"], P[f"{prefix}.norm2.bias"], eps)
    return (y + mlp(nm, ln2, P, f"{prefix}.linear1", f"{prefix}.linear2"))[:, 0]


def divided_attention(nm, P, prefix: str, x, heads: int, f: int, n: int, mode: str):
    """x (B, 1 + f*n, D) LayerNormed tokens [CLS; frame-major patches] ->
    the projected divided attention (B, 1 + f*n, D): the CLS query over all
    tokens; each patch over the CLS key and its group (its frame in 'space',
    its spatial position over the frames in 'time')."""
    b, _, d = x.shape
    dh = d // heads
    qkv = nm.linear(x, P[f"{prefix}.qkv.weight"], P[f"{prefix}.qkv.bias"])
    q, k, v = (_heads(t, heads) for t in qkv.split(d, dim=-1))  # (B, 1 + fn, H, dh)
    out_c = attention(nm, q[:, :1].transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    out_c = out_c.transpose(1, 2).reshape(b, 1, d)

    def groups(t):
        t = t[:, 1:].reshape(b, f, n, heads, dh)
        return t.transpose(1, 2) if mode == "time" else t  # (B, G, L, H, dh)

    qp, kp, vp = groups(q), groups(k), groups(v)
    gcount, length = qp.shape[1], qp.shape[2]
    kc = k[:, :1].reshape(b, 1, 1, heads, dh).expand(b, gcount, 1, heads, dh)
    vc = v[:, :1].reshape(b, 1, 1, heads, dh).expand(b, gcount, 1, heads, dh)
    kg = torch.cat([kc, kp], dim=2).permute(0, 1, 3, 2, 4)
    vg = torch.cat([vc, vp], dim=2).permute(0, 1, 3, 2, 4)
    out_p = attention(nm, qp.permute(0, 1, 3, 2, 4), kg, vg).permute(0, 1, 3, 2, 4)
    if mode == "time":
        out_p = out_p.transpose(1, 2)
    out = torch.cat([out_c, out_p.reshape(b, f * n, d)], dim=1)
    return nm.linear(out, P[f"{prefix}.proj.weight"], P[f"{prefix}.proj.bias"])


def _scale(t: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x if t is None else x * t.reshape(-1, *(1,) * (x.ndim - 1))


def video_tower(nm, P, s: dict, patches: torch.Tensor, factors=None) -> torch.Tensor:
    """Normalised patch-major frames (B, S, f, n, z*p*p*3) f32 -> per frame
    features (B, S, f, D) after the spatial CLS pool. ``factors``: per
    block the (space, MLP) drop-path factors (BS,), or None."""
    v, d = s["video"], s["d"]
    b, seg, f, n, pk = patches.shape
    p = "vfeat_extractor"
    w = P[f"{p}.patch_embed_3d.proj.weight"].permute(0, 2, 3, 4, 1).reshape(d, -1)
    tok = nm.linear(patches.reshape(b * seg, f, n, pk), w, P[f"{p}.patch_embed_3d.proj.bias"])
    tok = tok + P[f"{p}.pos_embed"][:, None, 1:] + P[f"{p}.temp_embed"][:, :, None]
    cls = (P[f"{p}.cls_token"] + P[f"{p}.pos_embed"][:, :1]).expand(b * seg, 1, d)
    x = torch.cat([cls, tok.reshape(b * seg, f * n, d)], dim=1)
    eps = 1e-6
    for i in range(v["depth"]):
        blk = f"{p}.blocks.{i}"
        fs, fm = (None, None) if factors is None else factors[i]

        def ln(t, nm_):
            return layer_norm(t, P[f"{blk}.{nm_}.weight"], P[f"{blk}.{nm_}.bias"], eps)

        x = x + divided_attention(nm, P, f"{blk}.timeattn", ln(x, "norm3"), v["heads"], f, n,
                                  "time")
        x = x + _scale(fs, divided_attention(nm, P, f"{blk}.attn", ln(x, "norm1"), v["heads"],
                                             f, n, "space"))
        x = x + _scale(fm, mlp(nm, ln(x, "norm2"), P, f"{blk}.mlp.fc1", f"{blk}.mlp.fc2"))
    feats = layer_norm(x[:, 1:], P[f"{p}.norm.weight"], P[f"{p}.norm.bias"], eps)
    pooled = cls_pool(nm, P, f"{p}.spatial_attn_agg", feats.reshape(b * seg * f, n, d),
                      v["heads"])
    return pooled.reshape(b, seg, f, d)


def audio_tower(nm, P, s: dict, mel: torch.Tensor) -> torch.Tensor:
    """Log-mel (B, S, T, F) f32 -> per time-step features (B, S, t, D)
    after the frequency CLS pool."""
    a, d = s["audio"], s["d"]
    b, seg, t_spec, f_spec = mel.shape
    fd, td = _ast_grid(a)
    e = "afeat_extractor.ast.embeddings"
    img = mel.reshape(b * seg, t_spec, f_spec).transpose(1, 2).unsqueeze(1)
    cols = F.unfold(img, a["patch"], stride=a["stride"]).transpose(1, 2)  # freq-major
    w = P[f"{e}.patch_embeddings.projection.weight"].reshape(d, -1)
    tok = nm.linear(cols, w, P[f"{e}.patch_embeddings.projection.bias"])
    aux = torch.cat([P[f"{e}.cls_token"], P[f"{e}.distillation_token"]], dim=1)
    x = torch.cat([aux.expand(b * seg, 2, d), tok], dim=1) + P[f"{e}.position_embeddings"]
    eps = 1e-12
    h = a["heads"]
    for i in range(a["depth"]):
        lay = f"afeat_extractor.ast.encoder.layer.{i}"
        att = f"{lay}.attention.attention"
        ln = layer_norm(x, P[f"{lay}.layernorm_before.weight"], P[f"{lay}.layernorm_before.bias"],
                        eps)
        q, k, vv = (_heads(nm.linear(ln, P[f"{att}.{nm_}.weight"], P[f"{att}.{nm_}.bias"]),
                           h).transpose(1, 2) for nm_ in ("query", "key", "value"))
        o = attention(nm, q, k, vv).transpose(1, 2).reshape(x.shape)
        x = x + nm.linear(o, P[f"{lay}.attention.output.dense.weight"],
                          P[f"{lay}.attention.output.dense.bias"])
        ln2 = layer_norm(x, P[f"{lay}.layernorm_after.weight"], P[f"{lay}.layernorm_after.bias"],
                         eps)
        x = x + mlp(nm, ln2, P, f"{lay}.intermediate.dense", f"{lay}.output.dense")
    x = layer_norm(x, P["afeat_extractor.ast.layernorm.weight"],
                   P["afeat_extractor.ast.layernorm.bias"], eps)
    feats = x[:, 2:].reshape(b * seg, fd, td, d).transpose(1, 2).reshape(b * seg * td, fd, d)
    pooled = cls_pool(nm, P, "afeat_extractor.freq_attn_agg", feats, h)
    return pooled.reshape(b, seg, td, d)


def offset_transformer(nm, P, s: dict, v, a, drops=None):
    """(B, Nv, D), (B, Na, D) projected features -> (B, num_cls) logits.
    ``drops``: a callable shape -> keep-scale (training) or None."""
    t = s["transformer"]
    p = "transformer"
    b, _, d = v.shape
    eps = 1e-5
    v = layer_norm(v, P[f"{p}.vis_in_lnorm.weight"], P[f"{p}.vis_in_lnorm.bias"], eps)
    a = layer_norm(a, P[f"{p}.aud_in_lnorm.weight"], P[f"{p}.aud_in_lnorm.bias"], eps)
    x = torch.cat([P[f"{p}.OFF_tok"].expand(b, 1, d), v, P[f"{p}.MOD_tok"].expand(b, 1, d), a],
                  dim=1)
    x = x + P[f"{p}.pos_emb_cfg.pos_emb"][:, :x.shape[1]]
    n = x.shape[1]
    h = t["n_head"]
    hid = int(d * t["mlp_ratio"])

    def drop(shape):
        return None if drops is None else drops(shape)

    keep = drop((b, n, d))
    if keep is not None:
        x = x * keep
    for i in range(t["n_layer"]):
        blk = f"{p}.blocks.{i}"
        ln = layer_norm(x, P[f"{blk}.ln1.weight"], P[f"{blk}.ln1.bias"], eps)
        q, k, vv = (_heads(nm.linear(ln, P[f"{blk}.attn.{nm_}.weight"],
                                     P[f"{blk}.attn.{nm_}.bias"]), h).transpose(1, 2)
                    for nm_ in ("query", "key", "value"))
        o = attention(nm, q, k, vv, drop((b, h, n, n))).transpose(1, 2).reshape(b, n, d)
        o = nm.linear(o, P[f"{blk}.attn.proj.weight"], P[f"{blk}.attn.proj.bias"])
        keep = drop((b, n, d))
        x = x + (o if keep is None else o * keep)
        ln2 = layer_norm(x, P[f"{blk}.ln2.weight"], P[f"{blk}.ln2.bias"], eps)
        x = x + mlp(nm, ln2, P, f"{blk}.mlp.0", f"{blk}.mlp.2",
                    (drop((b, n, hid)), drop((b, n, d))))
    x = layer_norm(x, P[f"{p}.ln_f.weight"], P[f"{p}.ln_f.bias"], eps)
    return nm.linear(x[:, 0], P[f"{p}.off_head.weight"], P[f"{p}.off_head.bias"])


def sync_features(nm, P, s: dict, patches, mel):
    """The towers and projections: (B, S*f, D) video and (B, S*t, D) audio
    tokens."""
    v = video_tower(nm, P, s, patches)
    a = audio_tower(nm, P, s, mel)
    v = nm.linear(v, P["vproj.weight"], P["vproj.bias"])
    a = nm.linear(a, P["aproj.weight"], P["aproj.bias"])
    b = v.shape[0]
    return v.reshape(b, -1, v.shape[-1]), a.reshape(b, -1, a.shape[-1])


@torch.no_grad()
def sync_logits(nm, P, s: dict, video_u8_patches, pcm) -> torch.Tensor:
    """Sync inference: uint8 patch-major video (B, S, f, n, z*p*p*3) and PCM
    (B, S, L) -> (B, num_cls) f32 offset logits."""
    mel = log_mel(pcm, s["audio"]["n_mels"], s["audio"]["max_spec_t"])
    v, a = sync_features(nm, P, s, normalize_u8(video_u8_patches), mel)
    return offset_transformer(nm, P, s, v, a)


# ---------------------------------------------------------------------------
# training


def _flip_frames(g: torch.Generator, video_u8, p_flip: float) -> torch.Tensor:
    """uint8 frames (B, S, T, H, W, C) -> normalised f32, each clip flipped
    along W where its draw falls under ``p_flip`` (one draw a clip)."""
    x = video_u8.float() / 255.0
    flip = torch.rand(x.shape[0], generator=g, device=x.device) < p_flip
    x = torch.where(flip.reshape(-1, *(1,) * (x.ndim - 1)), x.flip(-2), x)
    return (x - 0.5) / 0.5


def drop_path_factors(g: torch.Generator, n: int, rate: float, device):
    if rate == 0.0:
        return None
    keep = torch.rand(n, generator=g, device=device) < 1.0 - rate
    return keep.float() / (1.0 - rate)


def avclip_loss(nm, P, s: dict, batch, g: torch.Generator) -> torch.Tensor:
    """One Stage I forward in training: flips, drop-path, the towers with
    their AveragePooling time tails, L2-normalised segment features and the
    symmetric InfoNCE with the clamped temperature dividing the
    similarities."""
    v = s["video"]
    frames = _flip_frames(g, batch["video"], s["p_horizontal_flip"])
    patches = patchify(frames, v["z"], v["patch"])
    b, seg = patches.shape[:2]
    rates = np.linspace(0.0, v["drop_path_rate"], v["depth"])
    factors = [tuple(drop_path_factors(g, b * seg, float(r), patches.device) for _ in range(2))
               for r in rates]
    mel = log_mel(batch["audio"], s["audio"]["n_mels"], s["audio"]["max_spec_t"])
    vf = video_tower(nm, P, s, patches, factors).mean(dim=2).reshape(b * seg, -1)
    af = audio_tower(nm, P, s, mel).mean(dim=2).reshape(b * seg, -1)
    vf = vf / vf.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    af = af / af.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    scale = P["logit_scale"].clamp(s["clamp_scale_min"], s["clamp_scale_max"])
    labels = torch.arange(b * seg, device=vf.device)
    sim = nm.matmul(vf, af.t()) / scale
    return (F.cross_entropy(sim, labels) + F.cross_entropy(sim.t(), labels)) / 2.0


def sync_loss(nm, P, s: dict, batch, g: torch.Generator, features=None) -> torch.Tensor:
    """One Stage II forward in training: flips, the frozen towers in eval,
    the projections and the offset transformer with its dropouts, the mean
    cross-entropy against the offset targets. ``features`` (the frozen
    towers' outputs for this batch, computed once) skips the towers."""
    frames = _flip_frames(g, batch["video"], s["p_horizontal_flip"])
    t = s["transformer"]
    rates = {"embd": t["embd_pdrop"], "attn": t["attn_pdrop"], "resid": t["resid_pdrop"]}
    if features is None:
        features = frozen_features(nm, P, s, frames, batch["audio"])
    vfe, afe = features
    v = nm.linear(vfe, P["vproj.weight"], P["vproj.bias"])
    a = nm.linear(afe, P["aproj.weight"], P["aproj.bias"])
    b = v.shape[0]
    order = iter(["embd"] + ["attn", "resid", "resid", "resid"] * t["n_layer"])

    def drops(shape):
        rate = rates[next(order)]
        keep = torch.rand(shape, generator=g, device=v.device) < 1.0 - rate
        return keep.float() / (1.0 - rate)

    logits = offset_transformer(nm, P, s, v.reshape(b, -1, v.shape[-1]),
                                a.reshape(b, -1, a.shape[-1]), drops)
    return F.cross_entropy(logits, batch["offset_target"].long())


@torch.no_grad()
def frozen_features(nm, P, s: dict, frames, pcm, rows: int = 8):
    """The frozen towers' (B, S, f, D) and (B, S, t, D) features of
    normalised frames, ``rows`` clips at a time."""
    v, a = s["video"], s["audio"]
    vs, as_ = [], []
    for i in range(0, frames.shape[0], rows):
        patches = patchify(frames[i:i + rows], v["z"], v["patch"])
        mel = log_mel(pcm[i:i + rows], a["n_mels"], a["max_spec_t"])
        vs.append(video_tower(nm, P, s, patches))
        as_.append(audio_tower(nm, P, s, mel))
    return torch.cat(vs), torch.cat(as_)


def trainable_names(s: dict, names) -> list:
    """The leaves a step updates: all of AVCLIP's; Stage II's projections and
    offset transformer."""
    if s["kind"] == "avclip":
        return list(names)
    return [n for n in names if n.split(".", 1)[0] in ("vproj", "aproj", "transformer")]


def lr_at(s: dict, step: int) -> float:
    """The configuration's learning rate at update ``step`` (0 first):
    Stage I's linear warm-up from base / warmup over warmup - 1 steps into a
    cosine decay; Stage II's constant_with_warmup from base / 100."""
    o = s["optimizer"]
    base, warm = o["lr"], o["warmup"]
    if o["schedule"] == "constant_with_warmup":
        init = base / 100.0
        return init + (base - init) * min(step, warm) / warm if step < warm else base
    if step < warm:
        span = max(warm - 1, 1)
        return base / warm + (base - base / warm) * min(step, span) / span
    total = max(o["total_steps"] - warm, 1)
    return base * 0.5 * (1.0 + math.cos(math.pi * min(step - warm, total) / total))


def reference_steps(s: dict, P0: Params, batches: list, seed: int,
                    nm: Numerics = Numerics()) -> dict:
    """Follow the configuration's first ``len(batches)`` training steps
    from the weights ``P0`` (f32, not modified) and the step generator
    seeded ``seed``: each step's loss, the first step's gradient as the
    optimizer receives it (clipped by the global norm), per leaf, and each
    leaf's change over all the steps. AdamW (decay on matrices) for AVCLIP
    with its logit scale clamped after each update; Adam for Stage II."""
    names = trainable_names(s, P0)
    P = {k: v.detach().clone() for k, v in P0.items()}
    leaves = [P[k].requires_grad_() for k in names]
    o = s["optimizer"]
    if o["name"] == "adamw":
        decay = [P[k] for k in names if P[k].ndim >= 2]
        rest = [P[k] for k in names if P[k].ndim < 2]
        opt = torch.optim.AdamW([{"params": decay, "weight_decay": o["weight_decay"]},
                                 {"params": rest, "weight_decay": 0.0}],
                                lr=0.0, betas=tuple(o["betas"]), eps=o["eps"])
    else:
        opt = torch.optim.Adam(leaves, lr=0.0, betas=tuple(o["betas"]), eps=o["eps"])
    device = leaves[0].device
    g = torch.Generator(device=device).manual_seed(int(seed))
    losses, first_grad = [], None
    for step, batch in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        if s["kind"] == "avclip":
            loss = avclip_loss(nm, P, s, batch, g)
        else:
            loss = sync_loss(nm, P, s, batch, g)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(x)
                                                     for x in grads]))
        factor = o["max_clip_norm"] / torch.clamp(norm, min=o["max_clip_norm"])
        for p, x in zip(leaves, grads):
            p.grad = x * factor
        if step == 0:
            first_grad = {k: float(torch.linalg.vector_norm(p.grad)) for k, p in
                          zip(names, leaves)}
        for group in opt.param_groups:
            group["lr"] = lr_at(s, step)
        opt.step()
        if s["kind"] == "avclip":
            with torch.no_grad():
                P["logit_scale"].clamp_(s["clamp_scale_min"], s["clamp_scale_max"])
        losses.append(float(loss.detach()))
        del loss, grads
    change = {k: float(torch.linalg.vector_norm(P[k].detach() - P0[k])) for k in names}
    return {"losses": losses, "grad": first_grad, "change": change}
