"""Normalisation layers (counterpart of paddle_tpu/nn/layer/norm.py).

The batch norms keep the reference's state and nothing else: parameters
``weight`` and ``bias``, buffers ``_mean`` (zeros) and ``_variance``
(ones), so ``convert`` carries a reference state name for name (torch's
``BatchNorm2d`` would add ``num_batches_tracked``). ``momentum`` is
Paddle's (see ``nn.functional.batch_norm``). The running statistics are
updated in place, so ``TrainStep``'s graph updates the same buffers at
every replay. A model built on the meta device sets them again in
``reset_parameters``.

``SyncBatchNorm``: the reference's is plain batch norm over a global batch
(XLA reduces across the sharded batch axis). The port's sums each
channel's count, sum and sum of squares over the data-parallel group (the
fleet's, else the world) when a process group of more than one rank is
initialised, so every rank normalises by the global batch's statistics;
it is plain batch norm otherwise.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as PF
from ..functional.norm import _channels_first, _out_dtype, _stats_cast
from ..initializer import Constant, Normal, ParamAttr
from .layers import ParamLayer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "RMSNorm",
           "SpectralNorm"]


class LayerNorm(ParamLayer, nn.LayerNorm):
    """Normalises the trailing ``normalized_shape`` dimensions with
    ``epsilon``; scale ones and shift zeros by default, either left out
    when its attr is False. Subclasses torch's, whose forward it uses."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        nn.Module.__init__(self)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = tuple(normalized_shape)
        self.eps = epsilon
        self.elementwise_affine = weight_attr is not False
        self.create_parameter("weight", self.normalized_shape, weight_attr,
                              default_initializer=Constant(1.0))
        self.create_parameter("bias", self.normalized_shape, bias_attr,
                              is_bias=True)


class _BatchNormBase(ParamLayer, nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        nn.Module.__init__(self)
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.create_parameter("weight", [num_features], weight_attr,
                              default_initializer=Constant(1.0))
        self.create_parameter("bias", [num_features], bias_attr,
                              is_bias=True)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        if not self._mean.is_meta:
            with torch.no_grad():
                self._mean.zero_()
                self._variance.fill_(1.0)

    def forward(self, x):
        return PF.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"{self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}, data_format={self._data_format}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class _GroupSum(torch.autograd.Function):
    """The sum over a group's ranks; its gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        from ...distributed import collective

        ctx.group = group
        out = x.clone()
        collective.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        from ...distributed import collective

        g = g.clone()
        collective.all_reduce(g, group=ctx.group)
        return g, None


def _data_parallel_group():
    """The fleet's data-parallel group, else the world; None when no process
    group of more than one rank is initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return None
    from ...distributed import collective
    from ...distributed.fleet import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    group = hcg.get_data_parallel_group() if hcg is not None \
        else collective.get_group(0)
    return group if group.nranks > 1 else None


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over the data-parallel group's whole batch (see the
    module's docstring)."""

    def forward(self, x):
        group = _data_parallel_group()
        if group is None or not self.training or self._use_global_stats:
            return super().forward(x)
        xf = _channels_first(_stats_cast(x), self._data_format)
        dims = [d for d in range(xf.dim()) if d != 1]
        n_local = xf.numel() // xf.shape[1]
        stats = torch.cat([xf.sum(dims), xf.square().sum(dims),
                           xf.new_full((1,), float(n_local))])
        stats = _GroupSum.apply(stats, group)
        C = xf.shape[1]
        n = stats[-1]
        mean = stats[:C] / n
        var = (stats[C:2 * C] / n - mean.square()).clamp_min(0.0)
        shape = [1, C] + [1] * (xf.dim() - 2)
        out = (xf - mean.view(shape)) * torch.rsqrt(
            var.view(shape) + self._epsilon)
        if self.weight is not None:
            out = out * _stats_cast(self.weight).view(shape) + \
                _stats_cast(self.bias).view(shape)
        with torch.no_grad():
            m = self._momentum
            unbiased = var * n / (n - 1).clamp_min(1.0)
            self._mean.mul_(m).add_((1 - m) * mean.to(self._mean.dtype))
            self._variance.mul_(m).add_(
                (1 - m) * unbiased.to(self._variance.dtype))
        if xf.dim() > 2 and self._data_format in ("NHWC", "NLC", "NDHWC"):
            out = out.movedim(1, -1)
        return out.to(_out_dtype(x, self.weight))

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm inside it (itself included)
        replaced by a ``SyncBatchNorm`` holding the same state."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            return cls._from(layer)
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer

    @classmethod
    def _from(cls, bn):
        new = cls.__new__(cls)
        nn.Module.__init__(new)
        new.__dict__.update({k: v for k, v in bn.__dict__.items()
                             if k not in ("_parameters", "_buffers",
                                          "_modules")})
        for name, p in bn._parameters.items():
            new.register_parameter(name, p)
        for name, b in bn._buffers.items():
            new.register_buffer(name, b)
        new.train(bn.training)
        return new


class GroupNorm(ParamLayer, nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        nn.Module.__init__(self)
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        self.create_parameter("weight", [num_channels], weight_attr,
                              default_initializer=Constant(1.0))
        self.create_parameter("bias", [num_channels], bias_attr,
                              is_bias=True)

    def forward(self, x):
        return PF.group_norm(x, self._num_groups, self._epsilon, self.weight,
                             self.bias, self._data_format)


class _InstanceNormBase(ParamLayer, nn.Module):
    """Parameters ``scale`` and ``bias`` (the reference's names), both left
    out when ``weight_attr`` is False."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        nn.Module.__init__(self)
        self._epsilon, self._data_format = epsilon, data_format
        if weight_attr is False:
            self.register_parameter("scale", None)
            self.register_parameter("bias", None)
            return
        self.create_parameter("scale", [num_features], weight_attr,
                              default_initializer=Constant(1.0))
        self.create_parameter("bias", [num_features], bias_attr,
                              is_bias=True)

    def forward(self, x):
        return PF.instance_norm(x, weight=self.scale, bias=self.bias,
                                eps=self._epsilon,
                                data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class RMSNorm(ParamLayer, nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        nn.Module.__init__(self)
        self._epsilon = epsilon
        self.create_parameter("weight", [hidden_size], weight_attr,
                              default_initializer=Constant(1.0))

    def forward(self, x):
        return PF.rms_norm(x, self.weight, self._epsilon)


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return PF.local_response_norm(x, *self.args)


class SpectralNorm(ParamLayer, nn.Module):
    """``weight / sigma``, ``sigma`` its largest singular value by
    ``power_iters`` power iterations from ``weight_u`` and ``weight_v``
    (parameters drawn from N(0, 1) that take no gradient; the iterations
    start from them at every call, as in the reference)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        nn.Module.__init__(self)
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        fixed = ParamAttr(trainable=False)
        self.create_parameter("weight_u", [h], fixed,
                              default_initializer=Normal(0.0, 1.0))
        self.create_parameter("weight_v", [w], fixed,
                              default_initializer=Normal(0.0, 1.0))

    def forward(self, weight):
        mat = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                    -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = mat.T @ u
            v = v / (v.norm() + self._eps)
            u = mat @ v
            u = u / (u.norm() + self._eps)
        return weight / (u @ mat @ v)
