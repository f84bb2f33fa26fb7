"""Transformer building blocks (synchformer_tpu/models/layers.py in PyTorch).

Parameters keep the reference torch state-dict names; matrices are torch
Linear layout (out, in). The compute dtype follows the activations: a layer
casts its matrices to its input's dtype where it uses them, so f32 master
parameters train under bf16 compute (the JAX ``precision: amp``), and a model
whose matrices were cast once (SyncPredictor) casts nothing. LN parameters and
biases stay f32 and are cast where they are used, as the JAX numerics helpers
do.

``impl`` chooses the route: 'kernel' sends the packed QKV through K3 where
the heads are ``groupable`` (the JAX layer's gate), the LN+MLP half through
K2 and the CLS-pool layer through K4 (each wrapper runs its plain version on
CPU tensors), or through K4b where the CLS row is row 0 of x; 'plain' is the
reference composition.

Training dropouts (JAX PreLNBlock with attn_dropout / resid_dropout /
drop_path): with a ``generator`` (training) and a rate above 0, the attention
probabilities, the projection's output, the attention branch's drop-path,
the MLP's hidden activations, its output and the MLP branch's drop-path are
drawn in that order, whatever the route. The routes follow the JAX block:
K3 only with no keep-mask and no live attention dropout; K4 (the whole
CLS-pool layer) only with no keep-mask and nothing stochastic; K2 only
where neither the residual dropout nor drop-path is live and every row is
computed (``query_rows`` None), with or without a keep-mask. Without a
generator every route is the eval code.

Keep-masks (JAX ``attention_bias_from_keep_mask``): a (..., N) boolean keep
of the keys becomes an additive f32 bias, 0 where kept and the f32 minimum
where masked, added to the f32 logits of every head and query.

``checkpoint_with_generator`` is torch.utils.checkpoint for a region that
draws from an explicit generator: the recompute draws the forward's numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from synchformer_tpu_torch.ops.kernels.cls_pool import fused_cls_pool, fused_cls_pool_tokens
from synchformer_tpu_torch.ops.kernels.fused_rows import fused_ln_mlp_residual, pitched
from synchformer_tpu_torch.ops.kernels.standard_attention import groupable, standard_attention
from synchformer_tpu_torch.ops.numerics import dense, exact_gelu, layer_norm


class Linear(nn.Module):
    """torch.nn.Linear's parameters with flax Dense numerics."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, x.dtype)


class LayerNorm(nn.Module):
    """torch.nn.LayerNorm's parameters with the f32 fast-variance numerics."""

    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, x.dtype)


class Container(nn.Module):
    """A named group of submodules, to reproduce nested state-dict names."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, mod in children.items():
            self.add_module(name, mod)


class DropPath(nn.Module):
    """Stochastic depth (timm DropPath, synchformer_tpu/models/layers.py::
    DropPath): one draw per sample from an explicit generator, kept samples
    scaled by 1 / (1 - rate). ``draw`` draws; ``drop`` multiplies, so that a
    caller can draw before a recomputed (checkpointed) region."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def draw(self, n: int, generator: torch.Generator, device,
             dtype: torch.dtype) -> Optional[torch.Tensor]:
        """drop_path_factors at this module's rate."""
        return drop_path_factors(n, self.rate, generator, device, dtype)

    @staticmethod
    def drop(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
        if scale is None:
            return x
        return x * scale.reshape(-1, *(1,) * (x.ndim - 1))


def drop_path_factors(n: int, rate: float, generator: torch.Generator, device,
                      dtype: torch.dtype) -> Optional[torch.Tensor]:
    """(n,) per-sample factors 0 or 1 / (1 - rate) in ``dtype``; None at rate
    0, where nothing is drawn."""
    if rate == 0.0:
        return None
    keep = torch.rand(n, generator=generator, device=device) < 1.0 - rate
    return (keep.float() / (1.0 - rate)).to(dtype)


def element_dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax nn.Dropout in training: each element kept with probability
    1 - rate (drawn from ``generator``) and scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def checkpoint_with_generator(fn: Callable, generator: Optional[torch.Generator], *args):
    """torch.utils.checkpoint of ``fn(*args, generator)``: the forward draws
    from ``generator`` (which so advances past the region's draws), the
    recompute from a copy of its state at the region's start, so that both
    draw the same numbers."""
    if generator is None:
        return checkpoint(fn, *args, None, use_reentrant=False)
    state = generator.get_state()
    calls = []

    def run(*a):
        g = generator
        if calls:  # the recompute
            g = torch.Generator(device=generator.device)
            g.set_state(state)
        calls.append(1)
        return fn(*a, g)

    return checkpoint(run, *args, use_reentrant=False)


def attention_bias_from_keep_mask(keep: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(..., N) keep of the keys (nonzero = attend) -> (..., 1, 1, N) f32
    additive bias: 0 where kept, the f32 minimum where masked."""
    if keep is None:
        return None
    neg = torch.finfo(torch.float32).min
    bias = torch.where(keep.bool(), 0.0, neg).to(torch.float32)
    return bias[..., None, None, :]


def scaled_dot_attention(q, k, v, dropout: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         bias: Optional[torch.Tensor] = None):
    """q, k, v (..., H, N, dh); f32 logits scaled by dh^-0.5 in f32, plus
    ``bias`` (broadcastable, f32) where given, f32 softmax, probabilities in
    the compute dtype, dropped at ``dropout`` where a generator is given."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if generator is not None:
        probs = element_dropout(probs, dropout, generator)
    return torch.matmul(probs, v)


@dataclasses.dataclass
class BlockParams:
    """The tensors of one pre-LN block, whatever its state-dict layout."""
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wqkv: torch.Tensor  # (3D, D), rows [q; k; v]
    bqkv: torch.Tensor
    wproj: torch.Tensor
    bproj: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def multi_head_self_attention(x, p: BlockParams, num_heads: int, impl: str,
                              query_rows: Optional[int] = None, attn_dropout: float = 0.0,
                              generator: Optional[torch.Generator] = None,
                              keep_mask: Optional[torch.Tensor] = None):
    """Fused-QKV MHSA with the output projection (JAX MultiHeadSelfAttention;
    its projection dropout is the caller's). ``keep_mask`` (..., N) masks
    keys. K3 only on impl='kernel' with groupable heads, no keep-mask and no
    live attention dropout, as the JAX layer."""
    d = x.shape[-1]
    dtype = x.dtype
    dh = d // num_heads
    lead = x.shape[:-2]
    bias = attention_bias_from_keep_mask(keep_mask)
    if query_rows is not None:
        q = dense(x[..., :query_rows, :], p.wqkv[:d], p.bqkv[:d], dtype)
        kv = dense(x, p.wqkv[d:], p.bqkv[d:], dtype)
        q = q.reshape(*lead, query_rows, num_heads, dh).transpose(-3, -2)
        kv = kv.reshape(*lead, x.shape[-2], 2, num_heads, dh)
        k, v = (t.transpose(-3, -2) for t in kv.unbind(-3))
        out = scaled_dot_attention(q, k, v, attn_dropout, generator, bias)
        out = out.transpose(-3, -2).reshape(*lead, query_rows, d)
        return dense(out, p.wproj, p.bproj, dtype)
    qkv = dense(x, p.wqkv, p.bqkv, dtype)
    if k3_route(impl, num_heads, dh, keep_mask, generator is not None and attn_dropout > 0.0):
        n = x.shape[-2]
        out = standard_attention(qkv.reshape(-1, n, 3 * d), num_heads, impl=impl)
        return dense(out.reshape(x.shape), p.wproj, p.bproj, dtype)
    qkv = qkv.reshape(*x.shape[:-1], 3, num_heads, dh)
    q, k, v = (t.transpose(-3, -2) for t in qkv.unbind(-3))
    out = scaled_dot_attention(q, k, v, attn_dropout, generator, bias)
    out = out.transpose(-3, -2).reshape(x.shape)
    return dense(out, p.wproj, p.bproj, dtype)


def k3_route(impl: str, num_heads: int, dh: int, keep_mask, attn_stochastic: bool) -> bool:
    """Whether a full-rows self-attention goes through K3 (JAX
    MultiHeadSelfAttention, layers.py:162-163): impl='kernel', groupable
    heads, no keep-mask, no live attention dropout."""
    return (impl == "kernel" and keep_mask is None and not attn_stochastic
            and groupable(num_heads, dh))


def k4_route(impl: str, query_rows: Optional[int], ndim: int, keep_mask,
             stochastic_any: bool) -> bool:
    """Whether a pre-LN block is the whole CLS-pool layer on K4 / K4b (JAX
    PreLNBlock, layers.py:278-282): impl='kernel', one query row of a 3-D x,
    no keep-mask, nothing stochastic."""
    return (impl == "kernel" and query_rows == 1 and ndim == 3 and keep_mask is None
            and not stochastic_any)


def k2_route(impl: str, query_rows: Optional[int], resid_stochastic: bool) -> bool:
    """Whether a pre-LN block's LN + MLP half goes through K2 (JAX
    PreLNBlock, layers.py:328): impl='kernel', every row computed, neither
    the residual dropout nor drop-path live (a keep-mask does not matter)."""
    return impl == "kernel" and query_rows is None and not resid_stochastic


def mlp(x, w1, b1, w2, b2, dropout: float = 0.0,
        generator: Optional[torch.Generator] = None):
    """fc1 -> exact GELU -> fc2 (JAX Mlp); with a generator, its dropout
    after the GELU and after fc2."""
    dtype = x.dtype
    h = exact_gelu(dense(x, w1, b1, dtype))
    if generator is not None:
        h = element_dropout(h, dropout, generator)
    h = dense(h, w2, b2, dtype)
    return h if generator is None else element_dropout(h, dropout, generator)


def preln_block(x, p: BlockParams, num_heads: int, eps: float, impl: str,
                query_rows: Optional[int] = None, cls_row=None, attn_dropout: float = 0.0,
                resid_dropout: float = 0.0, generator: Optional[torch.Generator] = None,
                keep_mask: Optional[torch.Tensor] = None, drop_path: float = 0.0):
    """x + attn(ln1(x)); x + mlp(ln2(x)) (JAX PreLNBlock.__call__).

    Routes for impl='kernel', as in the JAX package (layers.py:265-335):
    query_rows=1 on a 3-D x with no keep-mask and nothing stochastic -> the
    whole layer for the CLS row, K4 with a shared ``cls_row``, K4b without
    one (row 0 of x is the CLS row); otherwise the attention through K3
    (k3_route) and the LN+MLP half through K2 (k2_route). ``keep_mask``
    (..., N) masks keys (with ``cls_row``, N counts it). With a
    ``generator`` (training) the live dropouts and drop-path (one factor per
    sample, the attention and the MLP branch each) are drawn."""
    d = x.shape[-1]
    dtype = x.dtype
    train = generator is not None
    attn_stoch = train and attn_dropout > 0.0
    resid_stoch = train and (resid_dropout > 0.0 or drop_path > 0.0)
    if k4_route(impl, query_rows, x.ndim, keep_mask, attn_stoch or resid_stoch):
        mats = (p.ln1_w, p.ln1_b, p.wqkv.to(dtype), p.bqkv, p.wproj.to(dtype), p.bproj,
                p.ln2_w, p.ln2_b, p.w1.to(dtype), p.b1, p.w2.to(dtype), p.b2)
        if cls_row is not None:
            out = fused_cls_pool_tokens(x, cls_row.reshape(d), *mats, num_heads=num_heads,
                                        eps=eps, impl=impl)
        else:
            out = fused_cls_pool(x.contiguous(), *mats, num_heads=num_heads, eps=eps, impl=impl)
        return out[:, None, :]
    if cls_row is not None:
        cls = cls_row.reshape(1, 1, d).to(dtype).expand(x.shape[0], 1, d)
        x = torch.cat([cls, x], dim=1)
    attn = multi_head_self_attention(layer_norm(x, p.ln1_w, p.ln1_b, eps, dtype), p, num_heads,
                                     impl, query_rows, attn_dropout,
                                     generator if attn_stoch else None, keep_mask)
    if resid_stoch:
        attn = DropPath.drop(element_dropout(attn, resid_dropout, generator),
                             drop_path_factors(x.shape[0], drop_path, generator, x.device, dtype))
    if query_rows is not None:
        x = x[..., :query_rows, :]
    x = x + attn
    if k2_route(impl, query_rows, resid_stoch):
        return fused_ln_mlp_residual(x.contiguous(), p.ln2_w, p.ln2_b, p.w1.to(dtype),
                                     p.b1, pitched(p.w2, dtype), p.b2, eps, impl=impl)
    h = mlp(layer_norm(x, p.ln2_w, p.ln2_b, eps, dtype), p.w1, p.b1, p.w2, p.b2,
            resid_dropout, generator if resid_stoch else None)
    if resid_stoch:
        h = DropPath.drop(h, drop_path_factors(x.shape[0], drop_path, generator, x.device, dtype))
    return x + h


class PreLNBlock(nn.Module):
    """A pre-LN transformer block. Subclasses hold the parameters under their
    reference names and expose them through ``block_params``."""

    def __init__(self, num_heads: int, eps: float, attn_dropout: float = 0.0,
                 resid_dropout: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.attn_dropout = float(attn_dropout)
        self.resid_dropout = float(resid_dropout)
        self.drop_path = float(drop_path)

    def block_params(self) -> BlockParams:
        raise NotImplementedError

    def forward(self, x, impl: str = "plain", query_rows: Optional[int] = None,
                cls_row=None, generator: Optional[torch.Generator] = None,
                keep_mask: Optional[torch.Tensor] = None):
        """``generator``: training, the block's dropouts live; None: eval."""
        return preln_block(x, self.block_params(), self.num_heads, self.eps, impl,
                           query_rows, cls_row, self.attn_dropout, self.resid_dropout,
                           generator, keep_mask, self.drop_path)


class MinGPTBlock(PreLNBlock):
    """The sync transformer's block (ref: model/modules/transformer.py:79-97):
    ln1, ln2, attn.{query,key,value,proj}, mlp.0 / mlp.2; LN eps 1e-5."""

    def __init__(self, d: int, num_heads: int, eps: float = 1e-5, mlp_ratio: float = 4.0,
                 attn_dropout: float = 0.0, resid_dropout: float = 0.0, device=None):
        super().__init__(num_heads, eps, attn_dropout, resid_dropout)
        hidden = int(d * mlp_ratio)
        self.ln1 = LayerNorm(d, eps, device)
        self.ln2 = LayerNorm(d, eps, device)
        self.attn = Container(query=Linear(d, d, device=device), key=Linear(d, d, device=device),
                              value=Linear(d, d, device=device), proj=Linear(d, d, device=device))
        self.mlp = nn.ModuleList([Linear(d, hidden, device=device), nn.Identity(),
                                  Linear(hidden, d, device=device)])

    def block_params(self) -> BlockParams:
        a = self.attn
        return BlockParams(
            self.ln1.weight, self.ln1.bias,
            torch.cat([a.query.weight, a.key.weight, a.value.weight]),
            torch.cat([a.query.bias, a.key.bias, a.value.bias]),
            a.proj.weight, a.proj.bias, self.ln2.weight, self.ln2.bias,
            self.mlp[0].weight, self.mlp[0].bias, self.mlp[2].weight, self.mlp[2].bias)


class ASTLayer(PreLNBlock):
    """HF ASTLayer names (ref: hf_src/modeling_ast.py:281-323); LN eps 1e-12."""

    def __init__(self, d: int, num_heads: int, eps: float = 1e-12, mlp_ratio: float = 4.0,
                 attn_dropout: float = 0.0, resid_dropout: float = 0.0, device=None):
        super().__init__(num_heads, eps, attn_dropout, resid_dropout)
        hidden = int(d * mlp_ratio)
        self.layernorm_before = LayerNorm(d, eps, device)
        self.layernorm_after = LayerNorm(d, eps, device)
        self.attention = Container(
            attention=Container(query=Linear(d, d, device=device),
                                key=Linear(d, d, device=device),
                                value=Linear(d, d, device=device)),
            output=Container(dense=Linear(d, d, device=device)))
        self.intermediate = Container(dense=Linear(d, hidden, device=device))
        self.output = Container(dense=Linear(hidden, d, device=device))

    def block_params(self) -> BlockParams:
        a = self.attention.attention
        return BlockParams(
            self.layernorm_before.weight, self.layernorm_before.bias,
            torch.cat([a.query.weight, a.key.weight, a.value.weight]),
            torch.cat([a.query.bias, a.key.bias, a.value.bias]),
            self.attention.output.dense.weight, self.attention.output.dense.bias,
            self.layernorm_after.weight, self.layernorm_after.bias,
            self.intermediate.dense.weight, self.intermediate.dense.bias,
            self.output.dense.weight, self.output.dense.bias)


class ViTBlock(PreLNBlock):
    """The joint-attention Motionformer's block (ref: motionformer_src/
    vit_helper.py Block): norm1, attn.{qkv, proj}, norm2, mlp.{fc1, fc2}."""

    def __init__(self, d: int, num_heads: int, eps: float = 1e-6, mlp_ratio: float = 4.0,
                 resid_dropout: float = 0.0, drop_path: float = 0.0, device=None):
        super().__init__(num_heads, eps, 0.0, resid_dropout, drop_path)
        hidden = int(d * mlp_ratio)
        self.norm1 = LayerNorm(d, eps, device)
        self.norm2 = LayerNorm(d, eps, device)
        self.attn = Container(qkv=Linear(d, 3 * d, device=device),
                              proj=Linear(d, d, device=device))
        self.mlp = Container(fc1=Linear(d, hidden, device=device),
                             fc2=Linear(hidden, d, device=device))

    def block_params(self) -> BlockParams:
        return BlockParams(
            self.norm1.weight, self.norm1.bias, self.attn.qkv.weight, self.attn.qkv.bias,
            self.attn.proj.weight, self.attn.proj.bias, self.norm2.weight, self.norm2.bias,
            self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias)
