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

Training dropouts (the sync transformer's block, JAX PreLNBlock with
attn_dropout / resid_dropout): with a ``generator`` and a rate above 0, the
attention probabilities, the projection's output, the MLP's hidden
activations and its output are dropped element-wise, drawn in that order, and
the block takes the plain composition (as the JAX block leaves its kernels
when it is stochastic). Without a generator every route is the eval code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from synchformer_tpu_torch.ops.kernels.cls_pool import fused_cls_pool, fused_cls_pool_tokens
from synchformer_tpu_torch.ops.kernels.fused_rows import fused_ln_mlp_residual
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
        """(n,) per-sample factors 0 or 1 / (1 - rate) in ``dtype``; None at
        rate 0, where nothing is drawn."""
        if self.rate == 0.0:
            return None
        keep = torch.rand(n, generator=generator, device=device) < 1.0 - self.rate
        return (keep.float() / (1.0 - self.rate)).to(dtype)

    @staticmethod
    def drop(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
        if scale is None:
            return x
        return x * scale.reshape(-1, *(1,) * (x.ndim - 1))


def element_dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax nn.Dropout in training: each element kept with probability
    1 - rate (drawn from ``generator``) and scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def scaled_dot_attention(q, k, v, dropout: float = 0.0,
                         generator: Optional[torch.Generator] = None):
    """q, k, v (..., H, N, dh); f32 logits scaled by dh^-0.5 in f32, f32
    softmax, probabilities in the compute dtype, dropped at ``dropout`` where
    a generator is given."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
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
                              generator: Optional[torch.Generator] = None):
    """Fused-QKV MHSA with the output projection (JAX MultiHeadSelfAttention;
    its projection dropout is the caller's). K3 only on impl='kernel' with
    groupable heads and no live attention dropout, as the JAX layer."""
    d = x.shape[-1]
    dtype = x.dtype
    dh = d // num_heads
    lead = x.shape[:-2]
    if query_rows is not None:
        q = dense(x[..., :query_rows, :], p.wqkv[:d], p.bqkv[:d], dtype)
        kv = dense(x, p.wqkv[d:], p.bqkv[d:], dtype)
        q = q.reshape(*lead, query_rows, num_heads, dh).transpose(-3, -2)
        kv = kv.reshape(*lead, x.shape[-2], 2, num_heads, dh)
        k, v = (t.transpose(-3, -2) for t in kv.unbind(-3))
        out = scaled_dot_attention(q, k, v, attn_dropout, generator)
        out = out.transpose(-3, -2).reshape(*lead, query_rows, d)
        return dense(out, p.wproj, p.bproj, dtype)
    qkv = dense(x, p.wqkv, p.bqkv, dtype)
    stochastic = generator is not None and attn_dropout > 0.0
    if impl == "kernel" and groupable(num_heads, dh) and not stochastic:
        n = x.shape[-2]
        out = standard_attention(qkv.reshape(-1, n, 3 * d), num_heads, impl=impl)
        return dense(out.reshape(x.shape), p.wproj, p.bproj, dtype)
    qkv = qkv.reshape(*x.shape[:-1], 3, num_heads, dh)
    q, k, v = (t.transpose(-3, -2) for t in qkv.unbind(-3))
    out = scaled_dot_attention(q, k, v, attn_dropout, generator)
    out = out.transpose(-3, -2).reshape(x.shape)
    return dense(out, p.wproj, p.bproj, dtype)


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
                resid_dropout: float = 0.0, generator: Optional[torch.Generator] = None):
    """x + attn(ln1(x)); x + mlp(ln2(x)) (JAX PreLNBlock.__call__).

    Routes for impl='kernel', as in the JAX package (layers.py:281-311):
    query_rows=1 on a 3-D x -> the whole layer for the CLS row, K4 with a
    shared ``cls_row``, K4b without one (row 0 of x is the CLS row);
    otherwise the attention goes through K3 (groupable heads) and the LN+MLP
    half through K2. With a ``generator`` and a dropout rate above 0 the
    block is stochastic and runs the plain composition with its dropouts."""
    d = x.shape[-1]
    dtype = x.dtype
    if generator is not None and attn_dropout == 0.0 and resid_dropout == 0.0:
        generator = None  # nothing to draw: the deterministic routes
    if query_rows == 1 and impl == "kernel" and x.ndim == 3 and generator is None:
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
    attn = multi_head_self_attention(layer_norm(x, p.ln1_w, p.ln1_b, eps, dtype),
                                     p, num_heads, impl, query_rows, attn_dropout, generator)
    if generator is not None:
        attn = element_dropout(attn, resid_dropout, generator)
    if query_rows is not None:
        x = x[..., :query_rows, :]
    x = x + attn
    if impl == "kernel" and query_rows is None and generator is None:
        return fused_ln_mlp_residual(x.contiguous(), p.ln2_w, p.ln2_b, p.w1.to(dtype),
                                     p.b1, p.w2.to(dtype), p.b2, eps, impl=impl)
    return x + mlp(layer_norm(x, p.ln2_w, p.ln2_b, eps, dtype), p.w1, p.b1, p.w2, p.b2,
                   resid_dropout, generator)


class PreLNBlock(nn.Module):
    """A pre-LN transformer block. Subclasses hold the parameters under their
    reference names and expose them through ``block_params``."""

    def __init__(self, num_heads: int, eps: float, attn_dropout: float = 0.0,
                 resid_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.eps = eps
        self.attn_dropout = float(attn_dropout)
        self.resid_dropout = float(resid_dropout)

    def block_params(self) -> BlockParams:
        raise NotImplementedError

    def forward(self, x, impl: str = "plain", query_rows: Optional[int] = None,
                cls_row=None, generator: Optional[torch.Generator] = None):
        """``generator``: training, the block's dropouts live; None: eval."""
        return preln_block(x, self.block_params(), self.num_heads, self.eps, impl,
                           query_rows, cls_row, self.attn_dropout, self.resid_dropout,
                           generator)


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
                 device=None):
        super().__init__(num_heads, eps)
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
