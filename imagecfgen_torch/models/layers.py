"""Layer library: the sequential-plan interpreter plus attribute conditioning
(port of ``imagecfgen_tpu/models/layers.py``).

A *plan* is a tuple of op descriptors (all shapes NHWC):

- ``("conv",  features, kernel, stride, padding)``
- ``("convT", features, kernel, stride, padding[, output_padding])``
- ``("lrelu", slope)``, ``("tanh",)``, ``("sigmoid",)``
- ``("bn",)``            batch norm over N,H,W: running statistics in eval,
  batch statistics (and a running-statistics update) in train mode
- ``("drop2d", rate)``   channel dropout: one keep per (sample, channel)
- ``("drop", rate)``     element dropout; both are the identity in eval
- ``("dense", features)``
- ``("flatten",)`` / ``("reshape", (h, w, c))``

PyTorch needs parameter shapes up front, so :class:`PlanSequential` walks
the plan from a given input shape. Parameter names follow the JAX package
(``conv_0_kernel``, ``convT_1_bias``, ``dense_0_kernel``, ``bn_0``); kernels
are stored in PyTorch's layouts (see :mod:`..ops.conv`), dense kernels as
``(out, in)``.

Train mode (``forward(x, train=True)``) follows flax: dropout keeps are
Bernoulli(1 - rate) with the kept values scaled by ``1 / (1 - rate)``, and
every mask is injectable (``masks``, in the order the plan consumes them;
drawn on the tensor's device from ``generator`` otherwise). Batch norm
normalises with the batch mean and the *biased* batch variance
``E[x^2] - E[x]^2`` in float32 and moves its running buffers by
``0.9 * running + 0.1 * batch``; the biased variance is also what it stores,
as flax does and ``torch.nn.BatchNorm2d`` does not.

As in the JAX package, a ``dense`` op directly followed by ``lrelu`` runs as
one ``ops.fused_dense.fused_dense_lrelu`` call (the hand-written CUDA kernel
on the card, its plain version on the CPU); a lone ``dense`` is
``F.linear``.

``compute_dtype`` (float32 or bfloat16) has the JAX package's semantics:
parameters stay float32 and are cast for the forward (the casts are cached
per parameter, ``ops.tensor_core.cast_cached``), activations stay in the
compute type end to end, and the callers return float32.
"""
from __future__ import annotations

import math
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.attributes import AttributeSpec
from ..device import DeviceLike, resolve_device
from ..ops.conv import (
    _pair,
    conv2d,
    conv_out_size,
    conv_transpose2d,
    conv_transpose_out_size,
)
from ..ops.fused_dense import fused_dense_lrelu
from ..ops.tensor_core import cast_cached

Plan = Tuple[Tuple[Any, ...], ...]


def _kernel_init(shape, std, fan_in: int, rng: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, std), or flax's ``lecun_normal`` (truncated, variance 1/fan_in)
    when ``std`` is None — the JAX package's ``conv_kernel_init``."""
    t = torch.empty(shape)
    if std is None:
        s = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        return nn.init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s, generator=rng)
    return nn.init.normal_(t, 0.0, std, generator=rng)


class BatchNorm(nn.Module):
    """Batch norm over all but the last axis with flax's semantics: running
    statistics in eval; in train mode the batch mean and the biased batch
    variance, which also move the running buffers by ``momentum``.

    ``mesh`` (a ``parallel.DataMesh``, set by :func:`sync_batch_norms`): the
    batch is sharded over its ranks, and the statistics are the global
    batch's, as GSPMD computes them: each rank's mean and ``E[x^2]``
    averaged over the ranks (equal shards) with a differentiable all-reduce,
    so every rank normalises alike and moves its running buffers alike."""

    momentum = 0.9  # flax's convention: the share of the old running value

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.mesh = None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        """``update_stats=False`` leaves the running buffers alone in train
        mode (a rematerialised forward must not move them twice)."""
        mean, var = self.mean, self.var
        if train:
            axes = tuple(range(x.dim() - 1))
            mean, sq = x.mean(axes), (x * x).mean(axes)
            if self.mesh is not None and self.mesh.group is not None:
                mean, sq = self.mesh.mean_across(torch.stack([mean, sq])).unbind(0)
            var = torch.clamp(sq - mean * mean, min=0.0)
            if update_stats:
                with torch.no_grad():
                    self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
                    self.var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def sync_batch_norms(module: nn.Module, mesh) -> None:
    """Every :class:`BatchNorm` of ``module`` computes its train-mode
    statistics over ``mesh``'s global batch."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Zero where ``keep`` is false, ``x / (1 - rate)`` elsewhere."""
    return torch.where(keep, x / (1.0 - rate), 0.0)


class PlanSequential(nn.Module):
    """Interpret a plan of op descriptors as a sequential network."""

    def __init__(
        self,
        plan: Plan,
        in_shape: Tuple[int, ...],
        init_std: Any = 0.01,
        device: DeviceLike = None,
        rng: Optional[torch.Generator] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        device = resolve_device(device)
        self.plan = tuple(plan)
        self.compute_dtype = compute_dtype
        shape = tuple(in_shape)
        conv_i = bn_i = dense_i = 0
        # (rate, per-sample mask shape) of every dropout op that draws a mask
        self.drop_specs: List[Tuple[float, Tuple[int, ...]]] = []
        for op in self.plan:
            kind = op[0]
            if kind in ("conv", "convT"):
                h, w, c = shape
                feats = op[1]
                (kh, kw), (sh, sw), (ph, pw) = _pair(op[2]), _pair(op[3]), _pair(op[4])
                if kind == "conv":
                    wshape = (feats, c, kh, kw)
                    shape = (conv_out_size(h, kh, sh, ph), conv_out_size(w, kw, sw, pw), feats)
                else:
                    oph, opw = _pair(op[5] if len(op) > 5 else 0)
                    wshape = (c, feats, kh, kw)
                    shape = (
                        conv_transpose_out_size(h, kh, sh, ph, oph),
                        conv_transpose_out_size(w, kw, sw, pw, opw),
                        feats,
                    )
                kernel = _kernel_init(wshape, init_std, kh * kw * c, rng)
                self.register_parameter(f"{kind}_{conv_i}_kernel", nn.Parameter(kernel))
                self.register_parameter(f"{kind}_{conv_i}_bias", nn.Parameter(torch.zeros(feats)))
                conv_i += 1
            elif kind == "dense":
                fan_in = shape[-1]
                kernel = _kernel_init((op[1], fan_in), None, fan_in, rng)
                self.register_parameter(f"dense_{dense_i}_kernel", nn.Parameter(kernel))
                self.register_parameter(f"dense_{dense_i}_bias", nn.Parameter(torch.zeros(op[1])))
                shape = (*shape[:-1], op[1])
                dense_i += 1
            elif kind == "bn":
                self.add_module(f"bn_{bn_i}", BatchNorm(shape[-1]))
                bn_i += 1
            elif kind == "flatten":
                shape = (math.prod(shape),)
            elif kind == "reshape":
                shape = tuple(op[1])
            elif kind in ("drop2d", "drop"):
                if not 0.0 <= op[1] < 1.0:
                    raise ValueError(f"dropout rate {op[1]} outside [0, 1)")
                if op[1] > 0.0:  # rate 0 is the identity and draws nothing, as in flax
                    mask = (*(1,) * (len(shape) - 1), shape[-1]) if kind == "drop2d" else shape
                    self.drop_specs.append((float(op[1]), tuple(mask)))
            elif kind not in ("lrelu", "tanh", "sigmoid"):
                raise ValueError(f"unknown plan op {op!r}")
        self.out_shape = shape
        self.to(device)

    def cast_parameters(self) -> dict:
        """The parameters by name, in the compute type."""
        return {k: cast_cached(v, self.compute_dtype) for k, v in self.named_parameters()}

    def draw_masks(self, batch: int, generator: Optional[torch.Generator],
                   device: DeviceLike) -> List[torch.Tensor]:
        """The keep masks of one train-mode forward at ``batch`` samples, in
        the order the plan consumes them: boolean, ``(batch, 1, 1, C)`` for
        ``drop2d`` and the activation's shape for ``drop``. One uniform draw
        on ``device`` from ``generator`` covers them all."""
        sizes = [batch * math.prod(shape) for _, shape in self.drop_specs]
        if not sizes:
            return []
        u = torch.rand(sum(sizes), generator=generator, device=device)
        return [(part >= rate).reshape(batch, *shape)
                for part, (rate, shape) in zip(u.split(sizes), self.drop_specs)]

    def forward(self, x: torch.Tensor, train: bool = False,
                masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True) -> torch.Tensor:
        """``train``: dropout is active and batch norm uses batch statistics.
        ``masks``: the dropout keep masks (see :meth:`draw_masks`), drawn
        from ``generator`` when None. ``update_stats``: see
        :class:`BatchNorm`."""
        cd = self.compute_dtype
        x = x.to(cd)
        if train and self.drop_specs:
            if masks is None:
                masks = self.draw_masks(x.shape[0], generator, x.device)
            if len(masks) != len(self.drop_specs):
                raise ValueError(f"{len(masks)} dropout masks for {len(self.drop_specs)} dropout ops")
        conv_i = bn_i = dense_i = drop_i = 0
        skip_next = False
        for idx, op in enumerate(self.plan):
            if skip_next:
                skip_next = False
                continue
            kind = op[0]
            if kind == "dense" and idx + 1 < len(self.plan) and self.plan[idx + 1][0] == "lrelu":
                kernel = cast_cached(getattr(self, f"dense_{dense_i}_kernel"), cd)
                bias = cast_cached(getattr(self, f"dense_{dense_i}_bias"), cd)
                lead = x.shape[:-1]
                y = fused_dense_lrelu(x.reshape(-1, x.shape[-1]).contiguous(), kernel, bias,
                                      self.plan[idx + 1][1])
                x = y.reshape(*lead, y.shape[-1])
                dense_i += 1
                skip_next = True
            elif kind == "conv" or kind == "convT":
                kernel = cast_cached(getattr(self, f"{kind}_{conv_i}_kernel"), cd)
                bias = cast_cached(getattr(self, f"{kind}_{conv_i}_bias"), cd)
                if kind == "conv":
                    x = conv2d(x, kernel, op[3], op[4]) + bias
                else:
                    outpad = op[5] if len(op) > 5 else 0
                    x = conv_transpose2d(x, kernel, op[3], op[4], output_padding=outpad) + bias
                conv_i += 1
            elif kind == "lrelu":
                x = F.leaky_relu(x, op[1])
            elif kind == "tanh":
                x = torch.tanh(x)
            elif kind == "sigmoid":
                x = torch.sigmoid(x)
            elif kind == "bn":
                # flax computes the normalisation in float32 (its statistics
                # and parameters) and casts the result to the compute type
                x = getattr(self, f"bn_{bn_i}")(x.float(), train, update_stats).to(cd)
                bn_i += 1
            elif kind in ("drop2d", "drop"):
                if train and op[1] > 0.0:
                    x = apply_dropout(x, masks[drop_i], op[1])
                    drop_i += 1
            elif kind == "dense":
                x = F.linear(
                    x, cast_cached(getattr(self, f"dense_{dense_i}_kernel"), cd),
                    cast_cached(getattr(self, f"dense_{dense_i}_bias"), cd),
                )
                dense_i += 1
            elif kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif kind == "reshape":
                x = x.reshape(x.shape[0], *op[1])
        return x


class AttributeChannels(nn.Module):
    """Render a conditioning dict as image channels (encoder side).

    Categorical attributes: embedding -> reshape ``embed_hw`` -> nearest
    upsample to the image size (``out[i] = in[floor(i*S/T)]``) -> tanh, one
    channel each. Continuous attributes: a constant channel. Channel order:
    image, categorical, continuous, each in sorted-name order.
    """

    def __init__(
        self,
        spec: AttributeSpec,
        image_size: Tuple[int, int],
        embed_dim: int = 256,
        embed_hw: Tuple[int, int] = (16, 16),
        device: DeviceLike = None,
        rng: Optional[torch.Generator] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.image_size = tuple(image_size)
        self.embed_hw = tuple(embed_hw)
        for a in spec.categorical:
            table = nn.init.normal_(torch.empty(a.n_categories, embed_dim), generator=rng)
            self.register_parameter(f"embed_{a.name}", nn.Parameter(table))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, attrs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        h, w = self.image_size
        eh, ew = self.embed_hw
        b = x.shape[0]
        cd = self.compute_dtype
        chans = [x.to(cd)]
        rows = torch.arange(h, device=x.device) * eh // h
        cols = torch.arange(w, device=x.device) * ew // w
        for a in self.spec.categorical:
            idx = torch.argmax(attrs[a.name], dim=-1)
            m = getattr(self, f"embed_{a.name}")[idx].reshape(b, eh, ew, 1)
            chans.append(torch.tanh(m[:, rows][:, :, cols]).to(cd))
        for a in self.spec.continuous:
            v = attrs[a.name].reshape(b, 1, 1, 1).to(cd)
            chans.append(v.expand(b, h, w, 1))
        return torch.cat(chans, dim=-1)


class AttributeVectors(nn.Module):
    """Render a conditioning dict as a flat feature vector (generator side).

    Categorical attributes are a *soft* ``one_hot @ table`` so convex
    mixtures of classes flow through the decoder; continuous attributes add
    one scalar each. Order: categorical then continuous, sorted by name.
    """

    def __init__(
        self,
        spec: AttributeSpec,
        embed_dim: int = 256,
        device: DeviceLike = None,
        rng: Optional[torch.Generator] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        for a in spec.categorical:
            table = nn.init.normal_(torch.empty(a.n_categories, embed_dim), generator=rng)
            self.register_parameter(f"embed_{a.name}", nn.Parameter(table))
        self.to(resolve_device(device))

    def forward(self, attrs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        cd = self.compute_dtype
        feats = [attrs[a.name].to(cd) @ cast_cached(getattr(self, f"embed_{a.name}"), cd)
                 for a in self.spec.categorical]
        feats += [attrs[a.name].reshape(-1, 1).to(cd) for a in self.spec.continuous]
        return torch.cat(feats, dim=-1)
