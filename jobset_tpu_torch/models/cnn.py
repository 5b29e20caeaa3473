"""ResNet-style CNN, the vision family: the port of `jobset_tpu/models/cnn.py`,
on one device or data-parallel over a gang's dp axis.

The tree keeps the JAX names and shapes: `stem`, `stem_scale`,
`stem_bias`, `stages` (a list of stages, each a list of block dicts
`conv1`, `scale1`, `bias1`, `conv2`, `scale2`, `bias2` and, on a block
that changes width or stride, `proj`), `head`, `head_bias`; conv weights
are HWIO `[kh, kw, cin, cout]`. A JAX tree converts leaf for leaf
(`convert.params_from_jax`) and gradients, optimizer states and
checkpoints line up with it.

Layout: activations are NHWC, as in the reference, and each convolution
passes `F.conv2d` a permuted view, NCHW of the activation and OIHW of the
weight. An NHWC tensor seen as NCHW is exactly PyTorch's `channels_last`
memory format, so the view costs no copy, cuDNN runs its NHWC kernels
(the tensor cores' layout in bf16), and its output, channels_last again,
permutes back to a contiguous NHWC tensor. GroupNorm, the pooling and the
head then read the reference's own layout.

Padding is XLA's "SAME": out = ceil(H / s) and the total padding
max((out - 1) s + k - H, 0) split as lo = total // 2 before and the rest
after. At stride 2 on an even size that is 0 before and 1 after, which
`F.conv2d(padding=1)` (1 on both sides) would shift by one pixel; so an
uneven split pads explicitly and convolves with padding 0.

Compute is in `cfg.dtype` (bf16 by default) over f32 params; GroupNorm
statistics, the pooled features and the head are f32; the loss is the
mean of -log_softmax(logits)[label]; the update is (p + u).to(p.dtype).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import tree
from ..device import resolve_device
from ..parallel.collectives import all_reduce_, reduce


@dataclass(frozen=True)
class CNNConfig:
    num_classes: int = 10
    in_channels: int = 3
    widths: tuple = (32, 64, 128)  # channels per stage; stride 2 between stages
    blocks_per_stage: int = 2
    groups: int = 8  # GroupNorm groups (must divide every width)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def validate(self) -> None:
        for w in self.widths:
            if w % self.groups:
                raise ValueError(f"GroupNorm groups {self.groups} must divide width {w}")


def init_params(config: CNNConfig, generator: torch.Generator, device=None) -> dict:
    """He-normal convs (normal * sqrt(2 / fan_in)), unit scales, zero biases
    and a normal / sqrt(width) head, drawn on the generator's device and
    placed on `device` (the card unless the caller names another). The
    numbers differ from the JAX `init_params`."""
    cfg = config
    cfg.validate()
    device = resolve_device(device)

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, dtype=cfg.param_dtype,
                        device=generator.device)
        return (w * std).to(device)

    def conv(kh, kw, cin, cout):
        return normal((kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)))

    def ones(n):
        return torch.ones(n, dtype=cfg.param_dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.param_dtype, device=device)

    first = cfg.widths[0]
    params = {"stem": conv(3, 3, cfg.in_channels, first), "stem_scale": ones(first),
              "stem_bias": zeros(first), "stages": []}
    cin = first
    for s, width in enumerate(cfg.widths):
        stage = []
        for b in range(cfg.blocks_per_stage):
            block = {"conv1": conv(3, 3, cin if b == 0 else width, width),
                     "scale1": ones(width), "bias1": zeros(width),
                     "conv2": conv(3, 3, width, width),
                     "scale2": ones(width), "bias2": zeros(width)}
            # The first block of every stage after the first downsamples, so
            # its shortcut is projected even at an unchanged width; stage 0
            # projects only on a change of width.
            if b == 0 and (s > 0 or cin != width):
                block["proj"] = conv(1, 1, cin, width)
            stage.append(block)
        params["stages"].append(stage)
        cin = width
    params["head"] = normal((cfg.widths[-1], cfg.num_classes), 1.0 / math.sqrt(cfg.widths[-1]))
    params["head_bias"] = zeros(cfg.num_classes)
    return params


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC, "SAME" padding, in x's dtype."""
    kh, kw = w.shape[0], w.shape[1]
    ph = same_padding(x.shape[1], kh, stride)
    pw = same_padding(x.shape[2], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))  # C, then W, then H
        padding = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale, bias, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over contiguous channel groups of an NHWC tensor, as the
    reference computes it: f32 mean and population variance over (H, W, the
    group's channels), rsqrt(var + eps), the affine in f32, cast back."""
    n, h, w, c = x.shape
    x32 = x.float().reshape(n, h, w, groups, c // groups)
    mean = x32.mean(dim=(1, 2, 4), keepdim=True)
    var = x32.var(dim=(1, 2, 4), keepdim=True, correction=0)
    x32 = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (x32 * scale.float() + bias.float()).to(x.dtype)


def _block(p: dict, x: torch.Tensor, cfg: CNNConfig, stride: int) -> torch.Tensor:
    shortcut = conv(x, p["proj"], stride) if "proj" in p else x
    y = conv(x, p["conv1"], stride)
    y = torch.relu(group_norm(y, p["scale1"], p["bias1"], cfg.groups))
    y = conv(y, p["conv2"])
    y = group_norm(y, p["scale2"], p["bias2"], cfg.groups)
    return torch.relu(shortcut + y)


def forward(params: dict, images: torch.Tensor, config: CNNConfig) -> torch.Tensor:
    """images [B, H, W, C] float -> f32 logits [B, num_classes], on the
    params' device."""
    cfg = config
    x = images.to(cfg.dtype)
    x = torch.relu(group_norm(conv(x, params["stem"]), params["stem_scale"],
                              params["stem_bias"], cfg.groups))
    for s, stage in enumerate(params["stages"]):
        for b, block in enumerate(stage):
            x = _block(block, x, cfg, stride=2 if (b == 0 and s > 0) else 1)
    x = x.float().mean(dim=(1, 2))  # global average pool
    return x @ params["head"].float() + params["head_bias"]


def loss_fn(params: dict, images: torch.Tensor, labels: torch.Tensor, config: CNNConfig,
            dp=None):
    """Mean over the batch of -log_softmax(logits)[label]; with a dp group,
    over the group's batch (its ranks hold equal shares)."""
    logits = forward(params, images, config)
    local = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None].long()).mean()
    if dp is None:
        return local
    return reduce(local, dp) / torch.distributed.get_world_size(dp)


def build_train_step(config: CNNConfig, optimizer, device=None, mesh=None):
    """train_step(params, opt_state, {"images", "labels"}) -> (params,
    opt_state, loss) on `device` (the card unless the caller names
    another), with an optimizer from `runtime.optim` applied as
    (p + u).to(p.dtype); over `mesh` the batch is the rank's dp slice, the
    loss the global batch's mean and the gradients averaged over dp (the
    reference's data-parallel step). The step returns new tensors and
    leaves its arguments as they were."""
    cfg = config
    cfg.validate()
    device = resolve_device(device)
    dp = mesh.group("dp") if mesh is not None else None

    def train_step(params, opt_state, batch):
        images, labels = (torch.as_tensor(batch[k]).to(device) for k in ("images", "labels"))
        loss, grads = tree.value_and_grad(loss_fn, params, images, labels, cfg, dp)
        all_reduce_(tree.leaves(grads), dp)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return tree.apply_updates(params, updates), opt_state, loss

    return train_step
