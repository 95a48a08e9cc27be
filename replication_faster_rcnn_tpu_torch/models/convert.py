"""Weights bridge: the JAX package's flax variables <-> this port's state dict.

The inverse of the layout rules of the JAX package's ``models/convert.py``
(which maps torchvision checkpoints onto the flax tree). Inputs and
outputs are numpy arrays, so the bridge needs neither framework's runtime
objects:

  * flax conv kernel [kh, kw, I, O] (HWIO)   <-> weight [O, I, kh, kw] (OIHW)
    (a grouped conv's [kh, kw, I/g, O] <-> [O, I/g, kh, kw], the same transpose)
  * flax Dense kernel [in, out]              <-> Linear weight [out, in]
  * params ``scale`` / ``bias``              <-> BatchNorm / GroupNorm ``weight`` / ``bias``
  * batch_stats ``mean`` / ``var``           <-> ``running_mean`` / ``running_var``

A GroupNorm model has no batch statistics: its flax tree's ``batch_stats``
is empty (flax omits the collection) and so is :func:`to_flax_variables`'.

Module paths are the flax tree's keys joined by dots (flax's ``layer1.0``
key is the ``layer1`` ModuleList's block 0), so the mapping is by name.

:func:`train_state_from_flax` carries a whole JAX ``TrainState`` (as numpy)
into the port's: the weights as above, optax's Adam moments through the
same per-leaf layouts, the update counts and the step.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.device import DeviceLike


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def kernel_from_flax(kernel: np.ndarray) -> np.ndarray:
    """A flax conv (HWIO) or Dense ([in, out]) kernel in the port's weight
    layout (OIHW, [out, in]), contiguous, any dtype."""
    if kernel.ndim == 4:
        return np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
    if kernel.ndim == 2:
        return np.ascontiguousarray(kernel.T)
    raise ValueError(f"expected a rank-2 or rank-4 kernel, got {kernel.shape}")


def kernel_to_flax(weight: np.ndarray) -> np.ndarray:
    """The inverse of :func:`kernel_from_flax`."""
    if weight.ndim == 4:
        return np.ascontiguousarray(weight.transpose(2, 3, 1, 0))
    if weight.ndim == 2:
        return np.ascontiguousarray(weight.T)
    raise ValueError(f"expected a rank-2 or rank-4 weight, got {weight.shape}")


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (numpy leaves) -> state dict."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables.get("params", {})).items():
        module, leaf = path.rsplit(".", 1)
        if leaf == "kernel" and value.ndim in (2, 4):
            state[f"{module}.weight"] = torch.from_numpy(kernel_from_flax(value))
        elif leaf == "scale":
            state[f"{module}.weight"] = torch.from_numpy(value.copy())
        elif leaf == "bias":
            state[f"{module}.bias"] = torch.from_numpy(value.copy())
        else:
            raise ValueError(f"unexpected flax parameter {path!r} {value.shape}")
    stats_names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        module, leaf = path.rsplit(".", 1)
        if leaf not in stats_names:
            raise ValueError(f"unexpected flax batch statistic {path!r}")
        state[f"{module}.{stats_names[leaf]}"] = torch.from_numpy(value.copy())
    return state


def to_flax_variables(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """State dict -> ``{"params", "batch_stats"}`` nested dicts of numpy
    arrays (the flax tree layout). BatchNorm modules are recognised by
    their running statistics; any other rank-1 ``weight`` is a GroupNorm's
    (conv and Linear weights are rank 4 and 2), so it maps to ``scale`` at
    its site too."""
    bn_modules = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
        *parents, leaf = _split(path)
        for p in parents:
            tree = tree.setdefault(p, {})
        tree[leaf] = value

    for key, tensor in state.items():
        module, leaf = key.rsplit(".", 1)
        value = tensor.detach().cpu().numpy()
        if module in bn_modules:
            if leaf == "weight":
                put(params, f"{module}.scale", value.copy())
            elif leaf == "bias":
                put(params, f"{module}.bias", value.copy())
            elif leaf == "running_mean":
                put(stats, f"{module}.mean", value.copy())
            elif leaf == "running_var":
                put(stats, f"{module}.var", value.copy())
            else:
                raise ValueError(f"unexpected BatchNorm entry {key!r}")
        elif leaf == "weight" and value.ndim in (2, 4):
            put(params, f"{module}.kernel", kernel_to_flax(value))
        elif leaf == "weight" and value.ndim == 1:
            put(params, f"{module}.scale", value.copy())
        elif leaf == "bias":
            put(params, f"{module}.bias", value.copy())
        else:
            raise ValueError(f"unexpected state entry {key!r} {value.shape}")
    return {"params": params, "batch_stats": stats}


def _split(path: str):
    """Split a dotted path into flax keys, rejoining ``layerN.<block>``
    (flax names a block ``layer1.0``; the state dict spells it with a dot)."""
    parts = path.split(".")
    out = []
    for p in parts:
        if p.isdigit() and out and out[-1].startswith("layer"):
            out[-1] = f"{out[-1]}.{p}"
        else:
            out.append(p)
    return out


def _as_float32(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _as_float32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _has(state: Any, name: str) -> bool:
    """Whether an optax state (a namedtuple) has the field: its fields only,
    since every tuple has a ``count`` method."""
    return name in getattr(state, "_fields", ())


def train_state_from_flax(state_np: Any, config, device: DeviceLike = None,
                          steps_per_epoch: int = 1):
    """The port's ``TrainState`` from a JAX ``TrainState`` whose leaves are
    numpy arrays (``jax.device_get`` of one, or an orbax restore into such a
    template), for every optimizer the JAX ``make_optimizer`` builds:

    * ``params`` and ``batch_stats`` through :func:`from_flax_variables`;
    * optax's chain state, one entry per transform: ``add_decayed_weights``'
      and the trust ratio's (``lars`` or ``lamb``) ``EmptyState``,
      ``ScaleByAdamState`` ``mu`` (bfloat16 under ``adam_mu_dtype``) / ``nu``
      / ``count`` into the optimizer's flat ``mu`` / ``nu`` (through the
      parameters' layouts, in parameter order) and ``count``, and the
      schedule's ``ScaleByScheduleState`` ``count``, which must equal
      Adam's (the guarded update gates both);
    * ``step`` into ``TrainState.step``.

    optax's counts count applied updates; ``TrainState.step`` counts
    dispatched batches, skipped ones included, so the two differ after a
    skip. The JAX rng key has no counterpart: the port's generator is
    seeded from ``config.train.seed``."""
    from replication_faster_rcnn_tpu_torch.train.train_step import create_train_state

    tc = config.train
    state = create_train_state(config, steps_per_epoch, device, seed=config.train.seed)
    model, optimizer = state.model, state.optimizer
    model.load_state_dict(from_flax_variables({
        "params": state_np.params, "batch_stats": state_np.batch_stats}))
    chain = list(state_np.opt_state)
    trust = int(tc.lars or tc.optimizer == "lamb")
    adam = [s for s in chain if _has(s, "mu") and _has(s, "nu")]
    sched = [s for s in chain if _has(s, "count") and not _has(s, "mu")]
    empty = [s for s in chain if not getattr(s, "_fields", ())]
    if len(chain) != 3 + trust or len(adam) != 1 or len(sched) != 1 or len(empty) != 1 + trust:
        raise ValueError(
            "expected optax's chain(add_decayed_weights, scale_by_adam, "
            f"{'scale_by_trust_ratio, ' if trust else ''}scale_by_learning_rate(schedule)) "
            f"state for this config, got {len(chain)} entries")
    count, sched_count = int(np.asarray(adam[0].count)), int(np.asarray(sched[0].count))
    if count != sched_count:
        raise ValueError(f"Adam's count {count} and the schedule's {sched_count} differ; "
                         "the port keeps one count for both")
    names = [name for name, _ in model.named_parameters()]
    for field, live, want in (("mu", optimizer.mu, tc.adam_mu_dtype),
                              ("nu", optimizer.nu, "float32")):
        tree = getattr(adam[0], field)
        dtypes = {str(np.asarray(v).dtype) for v in _flatten(tree).values()}
        if dtypes != {want}:
            raise ValueError(f"optax's {field} is {sorted(dtypes)}, the config wants {want}")
        # float32 first (torch takes no numpy bfloat16; the widening is exact)
        leaves = from_flax_variables({"params": _as_float32(tree)})
        live.copy_(torch.cat([leaves[n].reshape(-1) for n in names]))
    optimizer.count.fill_(count)
    state.step = int(np.asarray(state_np.step))
    return state
