"""Core layers of the CounteRGANs and the plain-generation GANs (mirrors
`cfgan/nn/layers.py`).

Activations are NHWC, as in the JAX package.  Parameter names follow the
JAX package's flax trees (`cfgan_torch.convert` maps one onto the other):
`Linear.weight` is torch's (out, in); a `Conv` on cuDNN holds an OIHW
`weight`; a `Conv` routed to the 3x3 kernel holds the HWIO `kernel`
(3, 3, Cin, Cout), which is the kernel's own layout; a `ConvTranspose`
holds torch's (in, out, k, k) `weight`.

Each layer draws its initial weights from an explicit `torch.Generator`
(`cfgan_torch.nn.init`); serving and the parity tests load trained or
converted weights over them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from cfgan_torch.nn import init as cinit
from cfgan_torch.ops import conv as conv_ops
from cfgan_torch.parallel.sharding import mesh_mean


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


class Linear(nn.Module):
    """Dense layer with torch-default init (U(+-1/sqrt(fan_in)))."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(cinit.scaled_uniform(
            (out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(cinit.scaled_uniform(
            (out_features,), in_features, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """2-D NHWC convolution with torch-default init and torch-style
    integer padding (`cfgan.nn.layers.Conv`).

    `impl` routes a 3x3/stride-1/pad-1 conv: "pallas" to the hand-written
    kernel through `conv3x3_same_pallas` (the port of the JAX package's
    Pallas kernel with its custom VJP), "matmul" to its plain version
    `conv3x3_same_plain`, which autograd differentiates.  As in the JAX
    package, "pallas" keeps a layer with Cin < 16 or Cout < 16 on cuDNN.
    Every other layer runs `F.conv2d` on a channels-last view of the NHWC
    activation, so no copy is made either way.  `use_bias=False` leaves
    the bias out (the discriminator's convs).  The kernel's init is
    U(+-1/sqrt(fan_in)), kaiming-normal with `kaiming_slope`, or
    N(0, normal_std^2) with `normal_std` (DCGAN's 0.02).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0,
                 impl: str | None = None, kaiming_slope: float | None = None,
                 use_bias: bool = True, normal_std: float | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if impl not in (None, "matmul", "pallas"):
            raise ValueError(f"unknown conv impl {impl!r}")
        k = kernel_size
        if impl == "pallas" and (in_ch < 16 or out_ch < 16):
            impl = None  # the JAX package's lane-starvation gate
        if impl is not None and not (k == 3 and stride == 1 and padding == 1):
            impl = None
        self.impl, self.stride, self.padding = impl, stride, padding
        fan_in = in_ch * k * k
        shape = (k, k, in_ch, out_ch)  # HWIO, the JAX layout
        if normal_std is not None:
            w = cinit.normal(shape, normal_std, generator)
        elif kaiming_slope is None:
            w = cinit.scaled_uniform(shape, fan_in, generator)
        else:
            w = cinit.kaiming_normal(shape, fan_in, kaiming_slope, generator)
        if impl is None:
            self.weight = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())
        else:
            self.kernel = nn.Parameter(w)
        self.bias = (nn.Parameter(cinit.scaled_uniform((out_ch,), fan_in,
                                                       generator))
                     if use_bias else None)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # A state dict carries over between impls, as the JAX package's
        # params do: an OIHW `weight` loads into a kernel layer's HWIO
        # `kernel`, and back.
        mine, other, perm = (("kernel", "weight", (2, 3, 1, 0)) if self.impl
                             else ("weight", "kernel", (3, 2, 0, 1)))
        if prefix + mine not in state_dict and prefix + other in state_dict:
            state_dict[prefix + mine] = state_dict.pop(
                prefix + other).permute(*perm)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl is None:
            y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                         self.stride, self.padding)
            return y.permute(0, 2, 3, 1).contiguous()
        fn = (conv_ops.conv3x3_same_pallas if self.impl == "pallas"
              else conv_ops.conv3x3_same_plain)
        y = fn(x.contiguous(), self.kernel)
        return y if self.bias is None else y + self.bias


class ConvTranspose(nn.Module):
    """2-D NHWC transposed convolution with torch's ConvTranspose2d
    geometry, output (H - 1) stride - 2 padding + k
    (`cfgan.nn.layers.ConvTranspose`), on cuDNN through
    `F.conv_transpose2d` on a channels-last view of the activation.

    `weight` is torch's (in, out, k, k).  The JAX package's kernel is
    flax's `transpose_kernel=True` (k, k, out, in), which maps onto it by
    `transpose(3, 2, 0, 1)` without a spatial flip.  Init: kernel and bias
    U(+-1/sqrt(out k k)) (torch's fan_in of this weight), or a kernel from
    N(0, normal_std^2) (DCGAN's 0.02)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, use_bias: bool = True,
                 normal_std: float | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        fan_in = out_ch * k * k
        shape = (in_ch, out_ch, k, k)
        self.weight = nn.Parameter(
            cinit.scaled_uniform(shape, fan_in, generator)
            if normal_std is None else cinit.normal(shape, normal_std,
                                                    generator))
        self.bias = (nn.Parameter(cinit.scaled_uniform((out_ch,), fan_in,
                                                       generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                               self.stride, self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with the JAX package's semantics
    (`cfgan.nn.layers.BatchNorm`).

    Train mode normalizes by the biased batch variance, taken as
    max(E[x^2] - E[x]^2, 0) in the input's dtype, and updates the running
    statistics in place with momentum 0.9 in the JAX convention (torch's
    0.1), the running variance from the unbiased variance n/(n-1); the
    running statistics keep their own dtype (float32 under mixed
    precision).  `update_stats=False` normalizes by the batch statistics
    and leaves the running ones alone (the JAX GAN step's G phase, which
    drops a BatchNorm discriminator's update; the CounteRGAN step's
    recomputed forward under `remat` and its `g_microbatch` chunks, whose
    statistics JAX drops too).  Eval mode normalizes by
    the running statistics.  `epsilon` defaults to 1e-5 (the simple MNIST
    generator's is 0.8); the scale starts at 1, or at `scale_init((n,),
    generator)`.

    Bound to a mesh (`mesh`, set by `cfgan_torch.parallel.replicate`:
    the counterpart of the JAX layer's `axis_name`), train mode averages
    the ranks' E[x] and E[x^2] with a differentiable all-reduce and counts
    n over every rank, so that each rank normalizes by the global batch's
    statistics and updates the same running ones; `update_stats=False`
    synchronises too.  Eval mode never synchronises.  Unbound (None), the
    layer is the single-process one.
    """

    momentum = 0.9
    mesh = None

    def __init__(self, features: int, epsilon: float = 1e-5,
                 scale_init=None, generator: torch.Generator | None = None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(features) if scale_init is None
            else scale_init((features,), generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            n = x.numel() // x.shape[-1]
            mean, mean_sq = x.mean(axes), (x * x).mean(axes)
            if self.mesh is not None:
                mean, mean_sq = mesh_mean(self.mesh, torch.stack(
                    [mean, mean_sq])).unbind()
                n *= self.mesh.world_size
            var = torch.maximum(mean_sq - mean * mean, x.new_zeros(()))
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * (n / max(n - 1, 1))
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight + self.bias


class InstanceNorm(nn.Module):
    """Affine instance norm of an NHWC tensor, torch's
    InstanceNorm2d(affine=True) without running statistics
    (`cfgan.nn.layers.InstanceNorm`): per sample and channel over H and W,
    by the biased variance mean((x - mean)^2), taken in float32 as
    `jnp.var` does for a bf16 input.  eps 1e-5."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean((1, 2), keepdim=True)
        xf = x.float()
        var = ((xf - xf.mean((1, 2), keepdim=True)) ** 2).mean(
            (1, 2), keepdim=True).to(x.dtype)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight + self.bias


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class SpectralLinear(nn.Module):
    """Linear layer under spectral normalization
    (`cfgan.nn.layers.SpectralLinear`): y = x W^T / sigma + b, sigma the
    power-iteration estimate of W's largest singular value, with u and v
    detached so that the gradient flows through W alone.

    With `update_stats` (the discriminator's update): v = n(W^T u),
    u' = n(W v), sigma = u'^T W v, and the buffer `u` becomes u' (in place,
    under no_grad, so that a replayed CUDA graph advances it once a call).
    Without: v = n(W^T u), sigma = u^T W v, and `u` stays.  n(a) =
    a / (|a| + eps).  `u` starts as a normalized N(0, 1) draw; under mixed
    precision it is read at the weight's dtype and stored in float32."""

    def __init__(self, in_features: int, out_features: int,
                 eps: float = 1e-12,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(cinit.scaled_uniform(
            (out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(cinit.scaled_uniform(
            (out_features,), in_features, generator))
        self.register_buffer("u", _l2_normalize(
            torch.randn((out_features,), generator=generator)))

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        w = self.weight
        with torch.no_grad():
            wd = w.detach()
            u = self.u.to(w.dtype, copy=True)
            v = _l2_normalize(u @ wd, self.eps)
            if update_stats:
                u = _l2_normalize(wd @ v, self.eps)
                self.u.copy_(u)
        sigma = torch.dot(w @ v, u)
        return F.linear(x, w / sigma, self.bias)


class FiLM(nn.Module):
    """Feature-wise linear modulation, gamma(cond) * h + beta(cond)
    (`cfgan.nn.layers.FiLM`)."""

    def __init__(self, cond_dim: int, hidden_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.gamma = Linear(cond_dim, hidden_dim, generator)
        self.beta = Linear(cond_dim, hidden_dim, generator)

    def forward(self, h: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return self.gamma(cond) * h + self.beta(cond)


class FiLMResidualBlock(nn.Module):
    """Tabular residual block, Linear-BN-FiLM-ReLU-Linear-BN-FiLM plus the
    skip, with ONE FiLM used at both sites
    (`cfgan.nn.layers.FiLMResidualBlock`)."""

    def __init__(self, hidden_dim: int, cond_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = Linear(hidden_dim, hidden_dim, generator)
        self.bn1 = BatchNorm(hidden_dim)
        self.film = FiLM(cond_dim, hidden_dim, generator)
        self.fc2 = Linear(hidden_dim, hidden_dim, generator)
        self.bn2 = BatchNorm(hidden_dim)

    def forward(self, h: torch.Tensor, cond: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        out = F.relu(self.film(self.bn1(self.fc1(h), update_stats), cond))
        out = self.film(self.bn2(self.fc2(out), update_stats), cond)
        return h + out


class Embed(nn.Module):
    """Embedding table; N(0, stddev) init (`cfgan.nn.layers.Embed`)."""

    def __init__(self, num_embeddings: int, features: int,
                 stddev: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(cinit.normal(
            (num_embeddings, features), stddev, generator))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight)


class ConvResBlock(nn.Module):
    """Image residual block with a damped residual path, identity +
    0.1 * out (`cfgan.nn.layers.ConvResBlock`)."""

    damping = 0.1
    negative_slope = 0.2

    def __init__(self, channels: int, conv_impl: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()

        def conv():
            return Conv(channels, channels, 3, 1, 1, impl=conv_impl,
                        kaiming_slope=self.negative_slope,
                        generator=generator)

        self.conv1, self.bn1 = conv(), BatchNorm(channels)
        self.conv2, self.bn2 = conv(), BatchNorm(channels)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        out = leaky_relu(self.bn1(self.conv1(x), update_stats),
                         self.negative_slope)
        out = self.bn2(self.conv2(out), update_stats)
        return x + self.damping * out


class Dropout(nn.Module):
    """Inverted dropout (`cfgan.nn.layers.Dropout`); identity in eval mode.
    `channelwise=True` drops whole channels of an NHWC tensor, as the JAX
    classifier's `broadcast_dims=(1, 2)` (torch's Dropout2d) does.

    In train mode the keep mask is `keep` where given (a boolean or 0/1
    tensor, (B, 1, 1, C) when channelwise: the parity tests inject
    JAX's), else drawn
    from `generator` on x's device; with neither it raises, since a draw
    from the global RNG could not be reproduced."""

    def __init__(self, rate: float, channelwise: bool = False):
        super().__init__()
        self.rate, self.channelwise = rate, channelwise

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if keep is None:
            if generator is None:
                raise ValueError("Dropout in train mode needs a generator "
                                 "or a keep mask")
            shape = ((x.shape[0], 1, 1, x.shape[-1]) if self.channelwise
                     else x.shape)
            keep = torch.rand(shape, generator=generator,
                              device=x.device) >= self.rate
        return x * keep.to(x.dtype) / (1.0 - self.rate)


def remat_call(block: nn.Module, *args: torch.Tensor,
               update_stats: bool = True) -> torch.Tensor:
    """`block(*args, update_stats)` under `torch.utils.checkpoint`
    (non-reentrant): the forward keeps the block's inputs and none of its
    activations, and the backward runs the block again to remake them.

    The block's parameters go in as the checkpoint's inputs, as they are
    at the call: under `make_mixed_precision` they are the compute-dtype
    casts that `functional_call` put in place, which are gone by the time
    the backward runs the block again.  The second run leaves the
    BatchNorm running statistics alone, as `jax.checkpoint` returns them
    once.  Nothing in a block draws random numbers, so the RNG state is
    not kept (`preserve_rng_state=False`), which also keeps `checkpoint`
    from reading the CUDA RNG state, as a CUDA graph capture forbids."""
    names, params = zip(*block.named_parameters())
    calls = []

    def run(*inputs):
        first = not calls
        calls.append(None)
        return functional_call(
            block, dict(zip(names, inputs[len(args):])), inputs[:len(args)],
            {"update_stats": update_stats and first})

    return checkpoint(run, *args, *params, use_reentrant=False,
                      preserve_rng_state=False)


def max_pool2d(x: torch.Tensor, window: int = 2,
               stride: int | None = None) -> torch.Tensor:
    """torch's MaxPool2d on an NHWC tensor (`cfgan.nn.layers.max_pool2d`):
    kernel `window`, stride defaulting to the kernel, no padding, floor
    output size (trailing rows and columns that fill no window are
    dropped)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return y.permute(0, 2, 3, 1).contiguous()


def one_hot(t: torch.Tensor, num_classes: int, dtype: torch.dtype
            ) -> torch.Tensor:
    """One-hot rows of `t` by comparison, which a CUDA graph captures
    (`F.one_hot` checks its input's range on the host)."""
    classes = torch.arange(num_classes, device=t.device)
    return (t[:, None] == classes).to(dtype)
