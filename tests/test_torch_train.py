"""Parity of the PyTorch port's training path with the JAX package at a small
size, on the CPU: ResNet18 at 96x96 (the ROIAlign and the ROIPool presets),
and in ``test_train_step_losses_match_jax`` also ``coco_resnet50``
(Bottlenecks, train-mode BatchNorm, 81 classes, ROIAlign) and
``coco_vgg16`` (ROIPool, 12 anchors, dropout), batch 2, compute float32,
the budgets of
``__graft_entry__._dryrun_body`` (pre_nms_train 192 -> 48, RPN n_sample 64,
ROI n_sample 16, max_boxes 4).

The JAX step keys its sampling with threefry; the port's step takes the same
uniforms, computed here in JAX from the step's own keys
(``fold_in(rng, step)`` -> split in 3 -> ``fold_in(key, image)`` -> split ->
``uniform``) and injected; the VGG16 tail's two dropout keep masks are the
JAX step's too (``_RecordDropout`` hands flax's masks to the host). Tolerances,
with their reasons:

* The four losses: rtol 1e-5 (observed ~5e-7). XLA:CPU and PyTorch sum the
  convolutions and BatchNorm statistics in different orders.
* ``coco_resnet50`` and ``coco_vgg16``: the losses, the gradient's norm and
  (VGG16) its leaves within twice the port's own float32 noise band where it
  exceeds those rtols (``_float32_band``: the same step at images scaled by
  1 -+ 1e-7; measured 5.1e-4 to 6.5e-4 of the ResNet50 norm, 2.3e-5 of its
  ``head_reg_loss``, 1.4e-4 of a VGG16 leaf's largest entry, at one to
  eight threads: ReLU masks flip on last-bit changes; JAX's value, the same
  in one program and in two, lies 7.0e-4 from the port's ResNet50 norm, and
  each VGG16 leaf's distance equals its band). The band itself is capped
  (``BAND_CEILING``: 1e-4 of a loss, 1e-3 of the norm, 3e-4 of a leaf's
  largest entry), so a noisier port fails instead of widening its own
  tolerance.
* The gradient's global norm: rtol 1e-4. For the ROIPool preset
  (``voc_resnet18``) it is held against the JAX gradient computed in two
  jitted programs that meet at the trunk's features
  (``_jax_grad_meeting_at_features``; the one-program jitted step loses
  part of its ROIPool gradient to XLA:CPU's FMA contraction, ROADMAP Queue
  C), and so is every leaf: within 1e-4 of the leaf's largest entry
  (measured 8e-6).
* Parameters after one Adam step: within 2.5 * lr of the JAX step's, the
  bound the JAX package's own parity tests use. Adam's first update is
  ~lr * sign(grad), so a gradient entry near zero whose sign differs in the
  last bits moves its parameter 2 * lr the other way.
* BatchNorm running statistics: rtol 1e-3 / atol 1e-5 (sums in other orders).
* Train-mode BatchNorm alone against flax: rtol 1e-5 / atol 1e-5 in float32;
  one bfloat16 ulp (rtol 2**-7) in bfloat16.
* Losses alone: rtol 1e-6 (``logsumexp`` rounds differently).
* A JAX checkpoint carried into the port (orbax save, JAX
  ``fault.verified_restore``, ``convert.train_state_from_flax``), then step
  2 on both sides with the JAX step's draws: the losses within
  ``__graft_entry__._assert_losses_agree``'s 1e-3 (relative, at least 1
  absolute); Adam's moments after step 2 within rtol 1e-4 of optax's
  (atol 1e-4 of the leaf's largest entry, for entries that cancel). The
  optax state of every optimizer option (``adam``, ``adam_mu_dtype=
  bfloat16``, ``lars``, ``lamb``) carries over bitwise.
* The optimizer chain against the JAX ``make_optimizer`` (un-jitted optax,
  seeded numpy parameters and gradients, 6 steps, 2 steps an epoch) for
  ``adam``, ``adam_mu_dtype=bfloat16``, ``lars``, ``lamb``,
  ``warmup_epochs`` and ``lr_scaling=linear``: the count and the lr (the
  float32 schedule on the device) equal; ``nu`` and the parameters within
  rtol 1e-6 (float32: ``decay**count`` and the trust ratio's norms round in
  another order); ``mu`` within rtol 1e-6, or one bfloat16 ulp (2**-7
  relative) when it is stored in bfloat16. The host schedule within rtol
  1e-15 of JAX's host twin, as before.
"""

import dataclasses
import io
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.data.loader import collate as j_collate
from replication_faster_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from replication_faster_rcnn_tpu.models.head import select_class_deltas as j_select
from replication_faster_rcnn_tpu.train import create_train_state
from replication_faster_rcnn_tpu.train import fault as j_fault
from replication_faster_rcnn_tpu.train import losses as j_losses
from replication_faster_rcnn_tpu.train.train_step import host_schedule as j_host_schedule
from replication_faster_rcnn_tpu.train.train_step import make_optimizer as j_make_optimizer
from replication_faster_rcnn_tpu.train.train_step import compute_losses as j_compute_losses
from replication_faster_rcnn_tpu.train.train_step import make_train_step as j_make_train_step
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch.data.loader import collate
from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from replication_faster_rcnn_tpu_torch.models.convert import (
    from_flax_variables,
    train_state_from_flax,
)
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
from replication_faster_rcnn_tpu_torch.models.head import select_class_deltas
from replication_faster_rcnn_tpu_torch.models.resnet import BatchNorm
from replication_faster_rcnn_tpu_torch.models.vgg import KEEP_MASK_NAMES
from replication_faster_rcnn_tpu_torch.ops import roi_ops
from replication_faster_rcnn_tpu_torch.ops.roi_ops import extract_roi_features
from replication_faster_rcnn_tpu_torch.train import losses
from replication_faster_rcnn_tpu_torch.train import fault
from replication_faster_rcnn_tpu_torch.train.fault import NonFiniteEscalation
from replication_faster_rcnn_tpu_torch.train.trainer import Trainer
from replication_faster_rcnn_tpu_torch.train.train_step import (
    DRAW_NAMES,
    TrainState,
    compute_losses,
    host_schedule,
    make_optimizer,
    make_train_step,
)
from tests.torch_threads import share_cores_among_xdist_workers

share_cores_among_xdist_workers()  # xdist workers' steps share the cores

SIZE = (96, 96)
LR = 1e-4
LOSSES = ("loss", "rpn_cls_loss", "rpn_reg_loss", "head_cls_loss", "head_reg_loss")
# the most _float32_band may reach, relative to the value it bands (see the
# module docstring: about twice the largest band measured)
BAND_CEILING = {"losses": 1e-4, "grad_norm": 1e-3, "leaves": 3e-4}


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def small(mod, cfg):
    return cfg.replace(
        data=mod.DataConfig(image_size=SIZE, max_boxes=4),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        proposals=mod.ProposalConfig(pre_nms_train=192, post_nms_train=48),
        rpn_targets=mod.RPNTargetConfig(n_sample=64),
        roi_targets=mod.ROITargetConfig(n_sample=16),
        train=mod.TrainConfig(batch_size=2, lr=LR),
    )


def tcfg_small(name="voc12_resnet18_align", **train):
    cfg = small(tconfig, tconfig.get_config(name))
    return cfg.replace(train=dataclasses.replace(cfg.train, **train))


def jax_step_draws(state, n, a, rg):
    """The uniforms the JAX step consumes, by the port's draw names."""
    rng_at, rng_pt, _ = jax.random.split(jax.random.fold_in(state.rng, state.step), 3)
    out = {name: [] for name in DRAW_NAMES}
    for i in range(n):
        for name, key in zip(DRAW_NAMES[:2], jax.random.split(jax.random.fold_in(rng_at, i))):
            out[name].append(np.asarray(jax.random.uniform(key, (a,))))
        for name, key in zip(DRAW_NAMES[2:], jax.random.split(jax.random.fold_in(rng_pt, i), 3)):
            out[name].append(np.asarray(jax.random.uniform(key, (rg,))))
    return {k: t(np.stack(v)) for k, v in out.items()}


def _np_vars(state):
    return {"params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


@pytest.fixture(scope="module")
def one_step():
    """One JAX train step (jitted) and the port's step from the bridged
    weights, the same batch and the JAX step's draws: ``voc12_resnet18_align``
    (ROIAlign head), and under ``"pool"`` the flagship ``voc_resnet18``
    (ROIPool head: the plain masked maxes and their autograd here, JAX's
    VJP there)."""
    return {**_one_step("voc12_resnet18_align"), "pool": _one_step("voc_resnet18")}


class _FeaturesIn:
    """A stand-in for the JAX model whose ``extract_features`` returns given
    features (and BatchNorm state): it lets the JAX ``compute_losses`` run
    as a function of the trunk's output."""

    def __init__(self, model, feat, mut):
        self.model, self.feat, self.mut, self.config = model, feat, mut, model.config

    def apply(self, variables, *args, method=None, **kw):
        if method == "extract_features":
            return self.feat, self.mut
        return self.model.apply(variables, *args, method=method, **kw)


def _jax_grad_meeting_at_features(jmodel, jcfg, state, jbatch):
    """The JAX step's gradient, by the port's parameter names, computed as
    two jitted programs that meet at the trunk's features: ``compute_losses``
    with the features as an input (the RPN and head parameters and the
    features), then the trunk's VJP.

    The jitted ``make_train_step`` is one program, and on a CPU with FMA
    XLA:CPU drops part of its ROIPool gradient (ROADMAP Queue C): its fusion
    pass recomputes the trunk's last block (BatchNorm scale and shift, add,
    ReLU) inside the fusions of the masked maxes' VJP, LLVM contracts that
    recomputation into FMAs, and wherever the recomputed feature differs in
    the last bit from the one the forward max saw, ``feat == max`` is false
    and the bin's gradient is lost (select, so no NaN). Here its global norm
    is 18.3280 against 18.4295; with ``--xla_cpu_max_isa=AVX`` (no FMA), or
    with the fusion pass off, the one program gives these two programs'
    gradient. The RPN and head leaves agree bitwise either way."""
    images = jnp.asarray(jbatch["image"])
    rng = jax.random.fold_in(state.rng, state.step)

    def trunk(params):
        return jmodel.apply({"params": params, "batch_stats": state.batch_stats}, images, True,
                            method="extract_features", mutable=["batch_stats"])

    def loss(params, feat, mut):
        return j_compute_losses(_FeaturesIn(jmodel, feat, mut), jcfg, params, state.batch_stats,
                                jbatch, rng)[0]

    feat, mut = jax.jit(trunk)(state.params)
    g_params, g_feat = jax.jit(jax.grad(loss, argnums=(0, 1)))(state.params, feat, mut)
    g_trunk = jax.jit(lambda p, g: jax.vjp(trunk, p, has_aux=True)[1](g)[0])(state.params, g_feat)
    total = jax.tree_util.tree_map(jnp.add, g_params, g_trunk)
    return from_flax_variables(_np_vars(state.replace(params=total)))


class _RecordDropout:
    """Within the block, every flax ``nn.Dropout`` draws its keep mask from
    the key it would draw anyway and hands the mask to the host
    (``jax.debug.callback``, so it works inside ``jax.jit`` and
    ``jax.grad``) by the port's names: the VGG16 tail's ``Dropout_0`` is
    fc6's, ``Dropout_1`` fc7's. The JAX package's source is not touched."""

    def __init__(self):
        self.masks = {}
        self._orig = fnn.Dropout.__call__

    def __enter__(self):
        orig, masks = self._orig, self.masks

        def call(mod, inputs, deterministic=None, rng=None):
            det = fnn.module.merge_param("deterministic", mod.deterministic, deterministic)
            if det or mod.rate == 0.0:
                return orig(mod, inputs, deterministic, rng)
            rng = mod.make_rng(mod.rng_collection) if rng is None else rng
            name = KEEP_MASK_NAMES[int(mod.name.split("_")[-1])]
            keep = jax.random.bernoulli(rng, p=1.0 - mod.rate, shape=inputs.shape)
            jax.debug.callback(lambda m, name=name: masks.__setitem__(name, np.asarray(m)),
                               keep)
            return orig(mod, inputs, deterministic, rng)

        fnn.Dropout.__call__ = call
        return self

    def __exit__(self, *exc):
        fnn.Dropout.__call__ = self._orig


def _one_step(name, **model_kw):
    """``model_kw``: ``ModelConfig`` overrides on both sides (the knobs)."""
    jcfg = small(jconfig, jconfig.get_config(name))
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, dataset="synthetic"),
                        model=dataclasses.replace(jcfg.model, **model_kw))
    tcfg = tcfg_small(name)
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, **model_kw))
    tx, _ = j_make_optimizer(jcfg, steps_per_epoch=1)
    jmodel, state = create_train_state(jcfg, jax.random.PRNGKey(0), tx)
    jbatch = j_collate([JSyntheticDataset(jcfg.data, length=2)[i] for i in range(2)])
    batch = collate([SyntheticDataset(tcfg.data, length=2)[i] for i in range(2)])
    assert all(np.array_equal(batch[k], jbatch[k]) for k in batch)
    with _RecordDropout() as dropout:  # the VGG16 tail's masks, as the JAX step draws them
        new_state, jmetrics = jax.jit(j_make_train_step(jmodel, jcfg, tx))(state, jbatch)
        jax.block_until_ready(jmetrics)
        split = None
        if jcfg.model.roi_op == "pool":
            split = _jax_grad_meeting_at_features(jmodel, jcfg, state, jbatch)
    assert set(dropout.masks) == (set(KEEP_MASK_NAMES) if jcfg.model.backbone == "vgg16"
                                  else set())

    model = build_model(tcfg, device="cpu", state_dict=from_flax_variables(_np_vars(state)))
    optimizer, _ = make_optimizer(tcfg, model.parameters(), 1)
    ts = TrainState(model, optimizer, torch.Generator().manual_seed(0))
    anchors = len(tcfg.anchors.ratios) * len(tcfg.anchors.scales)
    draws = jax_step_draws(state, 2, 6 * 6 * anchors, 48 + 4)
    draws.update({k: t(m) for k, m in dropout.masks.items()})
    tbatch = {k: t(batch[k]) for k in ("image", "boxes", "labels", "mask")}
    record = {}
    metrics = make_train_step(tcfg)(ts, tbatch, draws=draws, record=record)
    return {
        "jmetrics": {k: float(v) for k, v in jmetrics.items()},
        "jnew": from_flax_variables(_np_vars(new_state)),
        "jnew_state": new_state, "jcfg": jcfg, "jbatch": jbatch,
        "jstep": jax.jit(j_make_train_step(jmodel, jcfg, tx)),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "state": ts, "record": record, "draws": draws, "batch": tbatch, "tcfg": tcfg,
        "init": from_flax_variables(_np_vars(state)),
        "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
        "jgrad_split": split,
    }


def _case_jax_checkpoint_into_port(step, workdir):
    """After JAX step 1: an orbax save with the JAX manifest, the JAX
    verified restore, the bridge into the port's state, then step 2 on both
    sides with the JAX step's draws. The orbax directory is foreign to the
    port's store: a resume there raises and deletes nothing."""
    jcfg, tcfg, jstate = step["jcfg"], step["tcfg"], step["jnew_state"]
    mgr = ocp.CheckpointManager(str(workdir), options=ocp.CheckpointManagerOptions(
        max_to_keep=3, create=True))
    mgr.save(1, args=ocp.args.StandardSave(jstate))
    mgr.wait_until_finished()
    template = jax.device_get(jstate)
    j_fault.write_manifest(str(workdir), 1, template, jcfg)
    result = j_fault.verified_restore(mgr, template, str(workdir))
    mgr.close()
    assert result.step == 1 and result.manifest is not None and not result.discarded
    ts = train_state_from_flax(jax.tree_util.tree_map(np.asarray, result.state), tcfg, "cpu",
                               steps_per_epoch=1)
    assert ts.step == 1 and int(ts.optimizer.count) == 1
    # the host twin equals JAX's; the lr on the device equals JAX's float32 schedule
    assert host_schedule(tcfg, 1)(1) == j_host_schedule(jcfg, 1)(1)
    assert float(ts.optimizer.lr()) == float(j_make_optimizer(jcfg, 1)[1](jnp.int32(1)))
    jstate2, jmetrics = step["jstep"](result.state, step["jbatch"])
    draws = jax_step_draws(result.state, 2, 6 * 6 * 9, 48 + 4)
    metrics = make_train_step(tcfg)(ts, step["batch"], draws=draws)
    for k in LOSSES:  # __graft_entry__._assert_losses_agree
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= 1e-3 * max(1.0, abs(want)), k
    adam = jstate2.opt_state[1]
    opt = ts.optimizer
    for k in ("mu", "nu"):
        want = from_flax_variables({"params": jax.device_get(getattr(adam, k))})
        for (name, _), got in zip(ts.model.named_parameters(), opt.leaves(getattr(opt, k))):
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-4 * float(want[name].abs().max()),
                                       err_msg=f"{name} {k}")
    assert int(opt.count) == int(adam.count) == int(jstate2.opt_state[2].count) == 2
    assert ts.step == 2
    # the orbax directory is not the port's format: refused, nothing deleted
    listing = sorted(os.walk(workdir))
    trainer = Trainer(tcfg, SyntheticDataset(tcfg.data, length=2), device="cpu",
                      workdir=str(workdir))
    with pytest.raises(fault.ForeignCheckpointError, match="not this port's format"):
        trainer.train(resume=True)
    assert sorted(os.walk(workdir)) == listing


def _case_carried_optax_state(step):
    """``train_state_from_flax`` carries the optax state of every optimizer
    option (after two un-jitted updates) bitwise; a chain of another option
    is refused."""
    jstate = step["jnew_state"]
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0, 1e-2, p.shape).astype(np.float32)), jstate.params)
        for _ in range(2)]
    for option in ({}, {"adam_mu_dtype": "bfloat16"}, {"lars": True}, {"optimizer": "lamb"}):
        jcfg = step["jcfg"].replace(train=dataclasses.replace(step["jcfg"].train, **option))
        tx, _ = j_make_optimizer(jcfg, steps_per_epoch=1)
        opt_state, params = tx.init(jstate.params), jstate.params
        for g in grads:
            updates, opt_state = tx.update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
        carried = jax.tree_util.tree_map(
            np.asarray, jstate.replace(params=params, opt_state=opt_state, step=jnp.int32(3)))
        ts = train_state_from_flax(carried, tcfg_small(**option), "cpu")
        opt, adam = ts.optimizer, carried.opt_state[1]
        assert ts.step == 3 and int(opt.count) == 2 and opt.mu.dtype == getattr(
            torch, jcfg.train.adam_mu_dtype)
        for k in ("mu", "nu"):
            want = from_flax_variables(
                {"params": jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                                  getattr(adam, k))})
            for (name, _), got in zip(ts.model.named_parameters(), opt.leaves(getattr(opt, k))):
                assert torch.equal(got.float(), want[name]), (option, k, name)
        if option:  # this chain's state into the plain Adam config
            with pytest.raises(ValueError):
                train_state_from_flax(carried, tcfg_small(), "cpu")


def _float32_band(step, rel=1e-7):
    """The spread of the port's four losses, gradient norm and gradient
    leaves over the step's batch with its images scaled by 1, 1 - ``rel``
    and 1 + ``rel`` (the same weights and draws): the float32 noise floor of
    those values, where ReLU masks flip on last-bit changes. Measured at
    96x96: in the ResNet50 step ~6.5e-4 of the gradient norm and ~3e-5 of
    ``head_reg_loss`` (layer4's train-mode blocks), in the VGG16 step 1.4e-4
    of ``trunk.conv2_1.bias``'s largest entry, above rtol 1e-4 / 1e-5; the
    port's distance to JAX equals the band leaf by leaf. The ResNet18 steps
    are held at the plain rtols."""
    vals, grads = [], []
    for eps in (0.0, -rel, rel):
        model = build_model(step["tcfg"], device="cpu", state_dict=step["init"]).train()
        batch = dict(step["batch"], image=step["batch"]["image"] * (1 + eps))
        total, (metrics, _) = compute_losses(model, step["tcfg"], batch, draws=step["draws"])
        total.backward()
        row = {k: float(metrics[k]) for k in LOSSES}
        row["grad_norm"] = float(np.sqrt(sum(float((p.grad.double() ** 2).sum())
                                             for p in model.parameters())))
        vals.append(row)
        grads.append({k: p.grad for k, p in model.named_parameters()})
    band = {k: max(r[k] for r in vals) - min(r[k] for r in vals) for k in vals[0]}
    band["leaves"] = {k: max(float((g[k] - grads[0][k]).abs().max()) for g in grads[1:])
                      for k in grads[0]}
    return band


def _case_knob_steps(knobs, group):
    """The knob steps beside JAX's (held in the caller's loop): with
    ``remat`` and ``frozen_bn`` the running buffers end bitwise as they
    began (JAX's ``batch_stats`` too), and the step is bitwise the same step
    without ``remat`` (metrics, gradients, parameters); with ``norm="group"``
    the model has no BatchNorm buffers and JAX no ``batch_stats``."""
    init, end = knobs["init"], knobs["state"].model.state_dict()
    running = [k for k in init if "running" in k]
    assert running and all(torch.equal(end[k], init[k]) for k in running)
    assert all(torch.equal(knobs["jnew"][k], init[k]) for k in running)
    plain = _port_step(knobs, remat=False)
    assert plain["metrics"] == knobs["metrics"]
    assert all(torch.equal(plain["grads"][k], g) for k, g in knobs["grads"].items())
    assert all(torch.equal(plain["end"][k], v) for k, v in end.items())
    assert not any("running" in k for k in group["init"])
    assert not jax.tree_util.tree_leaves(group["jnew_state"].batch_stats)


def _port_step(step, **model_kw):
    """The port's step of ``step`` again from its initial weights, draws and
    batch, with ``model_kw`` overriding its model config."""
    tcfg = step["tcfg"].replace(model=dataclasses.replace(step["tcfg"].model, **model_kw))
    model = build_model(tcfg, device="cpu", state_dict=step["init"])
    optimizer, _ = make_optimizer(tcfg, model.parameters(), 1)
    ts = TrainState(model, optimizer, torch.Generator().manual_seed(0))
    metrics = make_train_step(tcfg)(ts, step["batch"], draws=step["draws"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "end": model.state_dict()}


def test_train_step_losses_match_jax(one_step, tmp_path):
    _case_jax_checkpoint_into_port(one_step, tmp_path / "orbax")
    _case_carried_optax_state(one_step)
    # the model knobs on the ResNet18 ROIAlign preset: remat with frozen
    # BatchNorm, and GroupNorm
    knobs = _one_step("voc12_resnet18_align", remat=True, frozen_bn=True)
    group = _one_step("voc12_resnet18_align", norm="group")
    _case_knob_steps(knobs, group)
    # coco_resnet50 (Bottlenecks, train-mode BatchNorm, 81 classes, ROIAlign)
    # and coco_vgg16 (ROIPool, 12 anchors, dropout with JAX's masks injected)
    # and coco_resnet50 on the ResNeXt trunk and tail (grouped 3x3s)
    for step in (one_step, one_step["pool"], knobs, group, _one_step("coco_resnet50"),
                 _one_step("coco_resnet50", backbone="resnext50_32x4d"),
                 _one_step("coco_vgg16")):
        got, want = step["metrics"], step["jmetrics"]
        # the ResNet50, ResNeXt50 and VGG16 steps: JAX within twice the
        # port's float32 noise band where that band is above the rtol
        # (_float32_band)
        band = (_float32_band(step) if step["tcfg"].model.backbone in (
                    "resnet50", "resnext50_32x4d", "vgg16")
                else {**dict.fromkeys(LOSSES + ("grad_norm",), 0.0), "leaves": {}})
        for k in LOSSES:
            assert band[k] <= BAND_CEILING["losses"] * abs(want[k]), (k, band[k], want[k])
            assert abs(got[k] - want[k]) <= max(1e-5 * abs(want[k]), 2 * band[k]), (
                k, got[k], want[k], band[k])
        for k in ("n_pos_rpn", "n_pos_head", "nonfinite_count", "skipped"):
            assert got[k] == want[k], k
        assert got["n_pos_rpn"] > 0 and got["n_pos_head"] > 0
        np.testing.assert_allclose(got["param_norm"], want["param_norm"], rtol=1e-6)
        jgrad = step["jgrad_split"]  # see _jax_grad_meeting_at_features
        if jgrad is None:
            assert band["grad_norm"] <= BAND_CEILING["grad_norm"] * abs(want["grad_norm"]), (
                band["grad_norm"], want["grad_norm"])
            assert abs(got["grad_norm"] - want["grad_norm"]) <= max(
                1e-4 * abs(want["grad_norm"]), 2 * band["grad_norm"]), (
                got["grad_norm"], want["grad_norm"], band["grad_norm"])
        else:
            grads = step["grads"]
            norm = np.sqrt(sum(float((jgrad[k].double() ** 2).sum()) for k in grads))
            np.testing.assert_allclose(got["grad_norm"], norm, rtol=1e-4)
            for k, g in grads.items():  # leaf by leaf (measured: 8e-6 of the largest entry)
                w = jgrad[k]
                err = float((g - w).abs().max())
                leaf_band = band["leaves"].get(k, 0.0)
                assert leaf_band <= BAND_CEILING["leaves"] * float(w.abs().max()), (k, leaf_band)
                assert err <= max(1e-4 * float(w.abs().max()),
                                  2 * leaf_band), (k, err)
        np.testing.assert_allclose(got["update_norm"], want["update_norm"], rtol=1e-3)
        assert step["record"]["draws"] is not step["draws"]
        assert set(step["record"]["draws"]) == set(step["draws"])
        assert all(torch.equal(step["record"]["draws"][k], v) for k, v in step["draws"].items())


def test_train_step_params_within_adam_bound(one_step):
    for step in (one_step, one_step["pool"]):
        state = step["state"].model.state_dict()
        want = step["jnew"]
        assert set(state) == set(want)
        moved = 0
        for k, w in want.items():
            g = state[k]
            if "running" in k:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-5, err_msg=k)
            else:
                assert float((g - w).abs().max()) <= 2.5 * LR, k
                moved += int((g != w).sum())
        assert moved > 0
        assert step["state"].step == 1 and int(step["state"].optimizer.count) == 1
    # cases folded into this id (each test id costs the fast tier's budget 2 s)
    _case_trunk_gets_a_gradient_through_roi_align(one_step)


def _case_trunk_gets_a_gradient_through_roi_align(one_step):
    """The head's loss reaches the trunk through the ROIAlign Function."""
    st, cfg = one_step["state"], one_step["tcfg"]
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, loss_weights=(0.0, 0.0, 1.0, 1.0)))
    model = st.model
    model.zero_grad(set_to_none=True)
    crops = []

    def extract(feat, *args, **kw):  # the head asks for crops in the feature's dtype
        out = extract_roi_features(feat, *args, **kw)
        assert kw["out_dtype"] == feat.dtype and out.dtype == feat.dtype
        crops.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(roi_ops, "extract_roi_features", extract)
        total, _ = compute_losses(model, cfg, one_step["batch"], draws=one_step["draws"])
    assert len(crops) == 1 and crops[0].requires_grad
    total.backward()  # the head's two losses only
    assert float(model.rpn.cls.weight.grad.abs().sum()) == 0.0
    conv = model.trunk.layer3[1].conv2.weight.grad
    assert conv is not None and float(conv.abs().sum()) > 0
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.pending_stats = None


# ----------------------------------------------------------- train-mode BN


def test_batchnorm_train_matches_flax():
    for dtype in ("float32", "bfloat16"):
        _batchnorm_case(dtype)
        _frozen_batchnorm_case(dtype)
        _groupnorm_case(dtype)
    # cases folded into this id (each test id costs the fast tier's budget 2 s)
    _case_losses_match_jax()
    _case_schedule_matches_jax()


def _norm_tol(dtype):
    """The BatchNorm case's tolerances: rtol/atol 1e-5 in float32, one
    bfloat16 ulp (2**-7) in bfloat16; gradients rtol 1e-4 / atol 1e-5 in
    float32."""
    return (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
            else dict(rtol=2**-7, atol=2**-7))


def _grad_pair(fmod, variables, x, dtype, tmod, rng):
    """The input gradients of ``sum(norm(x) * gy)`` through flax's module
    (``x`` cast to ``dtype`` inside) and the port's, both as NHWC float32."""
    jdt = jnp.dtype(dtype)
    gy = rng.normal(0, 1, x.shape).astype(np.float32)
    gx = jax.grad(lambda v: jnp.sum(fmod.apply(variables, v.astype(jdt)).astype(jnp.float32)
                                    * gy))(jnp.asarray(x))
    xt = t(x).permute(0, 3, 1, 2).requires_grad_()
    (tmod(xt.to(getattr(torch, dtype))).float() * t(gy).permute(0, 3, 1, 2)).sum().backward()
    return xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx)


def _frozen_batchnorm_case(dtype):
    """A frozen BatchNorm in training mode is flax's
    ``use_running_average=True``: forward and input gradient, no
    ``pending_stats``, buffers untouched."""
    rng = np.random.default_rng(4)
    x = rng.normal(0.5, 2.0, (3, 5, 4, 6)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.normal(0, 0.3, 6)
    mean0, var0 = rng.normal(0, 0.1, 6), rng.uniform(0.5, 1.5, 6)
    bias, mean0, var0 = (a.astype(np.float32) for a in (bias, mean0, var0))
    jdt = jnp.dtype(dtype)
    bn = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jdt,
                       param_dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want = bn.apply(variables, jnp.asarray(x).astype(jdt))
    mod = BatchNorm(6, frozen=True).train()
    with torch.no_grad():
        for buf, v in ((mod.weight, scale), (mod.bias, bias), (mod.running_mean, mean0),
                       (mod.running_var, var0)):
            buf.copy_(t(v))
    got = mod(t(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2))
    assert mod.training and mod.pending_stats is None and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want.astype(jnp.float32)), **_norm_tol(dtype))
    if dtype == "float32":
        got_g, want_g = _grad_pair(bn, variables, x, dtype, mod, rng)
        np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-5)
    assert torch.equal(mod.running_mean, t(mean0)) and torch.equal(mod.running_var, t(var0))
    assert mod.pending_stats is None


def _groupnorm_case(dtype):
    """``models/resnet.py::GroupNorm`` against flax ``nn.GroupNorm(32,
    epsilon=1e-5)`` (the JAX ``_norm(kind="group")``): forward in float32
    and bfloat16, and the input gradient (float32 within rtol 1e-4 / atol
    1e-5, bfloat16 within its ulp), on 64 channels (2 a group)."""
    from replication_faster_rcnn_tpu_torch.models.resnet import GroupNorm

    rng = np.random.default_rng(5)
    x = rng.normal(0.5, 2.0, (3, 5, 4, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.normal(0, 0.3, 64).astype(np.float32)
    jdt = jnp.dtype(dtype)
    gn = fnn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jdt, param_dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias}}
    want = gn.apply(variables, jnp.asarray(x).astype(jdt))
    mod = GroupNorm(64)
    with torch.no_grad():
        mod.weight.copy_(t(scale))
        mod.bias.copy_(t(bias))
    assert not list(mod.buffers())
    for training in (True, False):  # the same in both modes
        got = mod.train(training)(t(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want.astype(jnp.float32)), **_norm_tol(dtype))
    got_g, want_g = _grad_pair(gn, variables, x, dtype, mod.train(), rng)
    gtol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else _norm_tol(dtype)
    np.testing.assert_allclose(got_g, want_g, **gtol)


def _batchnorm_case(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(0.5, 2.0, (3, 5, 4, 6))).astype(np.float32)  # NHWC
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.3, 6).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 6).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    jdt = jnp.dtype(dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jdt, param_dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    xj = jnp.asarray(x).astype(jdt)
    want, upd = bn.apply(variables, xj, mutable=["batch_stats"])

    tdt = getattr(torch, dtype)
    mod = BatchNorm(6)
    with torch.no_grad():
        mod.weight.copy_(t(scale))
        mod.bias.copy_(t(bias))
        mod.running_mean.copy_(t(mean0))
        mod.running_var.copy_(t(var0))
    xt = t(x).to(tdt).permute(0, 3, 1, 2).requires_grad_()
    got = mod.train()(xt)
    assert got.dtype == tdt
    assert torch.equal(mod.running_mean, t(mean0))  # not committed by the forward
    new_mean, new_var = mod.pending_stats
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    if dtype == "float32":  # the gradient flows through the batch statistics
        gy = rng.normal(0, 1, x.shape).astype(np.float32)
        gx = jax.grad(lambda v: jnp.sum(bn.apply(variables, v, mutable=["batch_stats"])[0]
                                        * gy))(jnp.asarray(x))
        got.backward(t(gy).permute(0, 3, 1, 2))
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx),
                                   rtol=1e-4, atol=1e-5)
    mod.eval()  # inference mode: the running statistics
    ref = (t(x).permute(0, 3, 1, 2) - t(mean0).view(1, -1, 1, 1)) * (
        torch.rsqrt(t(var0) + 1e-5) * t(scale)).view(1, -1, 1, 1) + t(bias).view(1, -1, 1, 1)
    assert torch.equal(mod(t(x).permute(0, 3, 1, 2)), ref)


# -------------------------------------------------------------------- losses


def _case_losses_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.normal(0, 1.5, (2, 30, 4)).astype(np.float32)
    target = rng.normal(0, 1.5, (2, 30, 4)).astype(np.float32)
    labels = rng.integers(-1, 3, (2, 30))
    logits = rng.normal(0, 3, (2, 30, 21)).astype(np.float32)
    cls = rng.integers(-1, 21, (2, 30))
    for sigma in (1.0, 3.0):
        np.testing.assert_allclose(
            losses.smooth_l1(t(pred), t(target), sigma).numpy(),
            np.asarray(j_losses.smooth_l1(jnp.asarray(pred), jnp.asarray(target), sigma)),
            rtol=1e-6)
        np.testing.assert_allclose(
            float(losses.loc_loss(t(pred), t(target), t(labels), sigma)),
            float(j_losses.loc_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(labels), sigma)),
            rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.ignore_cross_entropy(t(logits), t(cls))),
        float(j_losses.ignore_cross_entropy(jnp.asarray(logits), jnp.asarray(cls))), rtol=1e-6)
    none = np.full((2, 30), -1)  # nothing positive, nothing valid: 0, not NaN
    assert float(losses.loc_loss(t(pred), t(target), t(none))) == 0.0
    assert float(losses.ignore_cross_entropy(t(logits), t(none))) == 0.0
    _case_select_class_deltas()


def _case_select_class_deltas():
    rng = np.random.default_rng(2)
    reg = rng.normal(0, 1, (2, 16, 21 * 4)).astype(np.float32)
    labels = rng.integers(-1, 21, (2, 16))
    want = np.asarray(j_select(jnp.asarray(reg), jnp.asarray(labels)))
    np.testing.assert_array_equal(select_class_deltas(t(reg), t(labels)).numpy(), want)


# the optimizer options of the JAX TrainConfig, one chain each
OPTIONS = (
    {},
    {"adam_mu_dtype": "bfloat16"},
    {"lars": True},
    {"optimizer": "lamb"},
    {"warmup_epochs": 1.5},
    {"lr_scaling": "linear", "batch_size": 16, "base_batch_size": 8},
)


def _option_cfgs(**train):
    train = {"lr": 1e-3, "n_epoch": 4, **train}
    return (jconfig.get_config("voc12_resnet18_align").replace(train=jconfig.TrainConfig(**train)),
            tconfig.get_config("voc12_resnet18_align").replace(train=tconfig.TrainConfig(**train)))


def _case_schedule_matches_jax():
    for option in OPTIONS + ({"warmup_epochs": 1.5, "lr_scaling": "linear", "batch_size": 4},):
        jcfg, cfg = _option_cfgs(**option)
        want = j_host_schedule(jcfg, 3)
        got = host_schedule(cfg, 3)
        _, j_sched = j_make_optimizer(jcfg, steps_per_epoch=3)
        optimizer, sched = make_optimizer(cfg, [torch.nn.Parameter(torch.ones(2))], 3)
        zeros = torch.zeros(2)
        for step in range(16):
            np.testing.assert_allclose(got(step), want(step), rtol=1e-15)
            # the device schedule, at the count the chain holds: JAX's float32 bits
            assert int(optimizer.count) == step
            assert float(sched(optimizer.count)) == float(j_sched(jnp.int32(step)))
            assert float(optimizer.lr()) == float(j_sched(jnp.int32(step)))
            optimizer.update(zeros, torch.ones(2), None)
    for option in OPTIONS:
        _case_chain_matches_optax(option)


def _case_chain_matches_optax(option, steps=6):
    """The chain against the JAX ``make_optimizer`` on the same parameters
    and gradients, un-jitted (see the tolerances above)."""
    jcfg, cfg = _option_cfgs(**option)
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3, 3, 2), "b": (7,), "c": (5, 6), "z": (3,)}  # z: zero, as a fresh bias
    params = {k: (np.zeros(v, np.float32) if k == "z" else
                  rng.normal(0, 0.5, v).astype(np.float32)) for k, v in shapes.items()}
    tx, j_sched = j_make_optimizer(jcfg, steps_per_epoch=2)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    live = [torch.nn.Parameter(t(params[k].copy())) for k in sorted(shapes)]
    opt, _ = make_optimizer(cfg, live, 2)
    assert opt.mu.dtype == getattr(torch, cfg.train.adam_mu_dtype)
    for step in range(steps):
        grads = {k: rng.normal(0, 10.0 ** (step % 3 - 1), v).astype(np.float32)
                 for k, v in shapes.items()}
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, j_state,
                                     j_params)
        j_params = optax.apply_updates(j_params, updates)
        flat_g = torch.cat([t(grads[k]).reshape(-1) for k in sorted(shapes)])
        flat_p = torch.cat([p.detach().reshape(-1) for p in live])
        lr = float(opt.lr())
        opt.update(flat_g, flat_p, None)
        adam = j_state[1]
        assert int(opt.count) == int(adam.count) == int(j_state[-1].count) == step + 1
        assert lr == float(j_sched(jnp.int32(step)))
        for k in sorted(shapes):
            i = sorted(shapes).index(k)
            mu_tol = 2**-7 if cfg.train.adam_mu_dtype == "bfloat16" else 1e-6
            np.testing.assert_allclose(opt.leaves(opt.mu)[i].float().numpy(),
                                       np.asarray(adam.mu[k], np.float32), rtol=mu_tol,
                                       atol=1e-30, err_msg=f"{option} mu {k} step {step}")
            np.testing.assert_allclose(opt.leaves(opt.nu)[i].numpy(), np.asarray(adam.nu[k]),
                                       rtol=1e-6, err_msg=f"{option} nu {k} step {step}")
            np.testing.assert_allclose(live[i].detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{option} params {k} step {step}")
    assert float(live[-1].detach().abs().sum()) > 0  # the zero leaf moved (trust ratio 1)


# ------------------------------------------------------- guarded update, trainer


def _state_snapshot(trainer):
    model = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt = {k: v.clone() for k, v in trainer.state.optimizer.state_dict().items()}
    return model, opt


def _same(a, b):
    (ma, oa), (mb, ob) = a, b
    return (all(torch.equal(ma[k], mb[k]) for k in ma)
            and all(torch.equal(oa[k], ob[k]) for k in oa))


@pytest.fixture(scope="module")
def trainer_and_batches(tmp_path_factory):
    """``Trainer.train`` for one epoch of 3 steps, every step logged."""
    cfg = tcfg_small(n_epoch=1)
    log = tmp_path_factory.mktemp("train") / "metrics.jsonl"
    trainer = Trainer(cfg, SyntheticDataset(cfg.data, length=6), device="cpu")
    trainer.logger.jsonl_path = str(log)
    trainer.logger._stream = io.StringIO()
    last = trainer.train(log_every=1)
    history = [r for r in map(json.loads, open(log)) if "step" in r]
    return trainer, history, last


def _case_trainer_three_steps_finite(trainer, history, last):
    assert len(history) == 3 and trainer.state.step == 3
    for m in history:
        assert all(np.isfinite(m[k]) for k in LOSSES) and m["skipped"] == 0.0
    # a row's lr is the schedule's at its (1-indexed) step, as the JAX trainer logs it:
    # the one epoch's lr, then 0 at its end
    assert [m["lr"] for m in history] == [trainer.host_schedule(s) for s in (1, 2, 3)]
    assert history[0]["lr"] == pytest.approx(LR, rel=1e-2) and history[-1]["lr"] == 0.0
    assert last == {k: v for k, v in history[-1].items() if k not in ("step", "t")}
    assert trainer.steps_per_epoch == 3 and trainer.model.training


def test_guarded_update_on_a_nan_gradient(trainer_and_batches, tmp_path):
    trainer, history, last = trainer_and_batches
    _case_trainer_three_steps_finite(trainer, history, last)
    for policy in ("skip", "halt", "apply"):
        _nan_step(trainer, policy)
    _case_group_norm_trainer(tmp_path)


def _case_group_norm_trainer(workdir):
    """A GroupNorm model (no BatchNorm statistics) through the trainer: a
    withheld NaN step leaves the state bitwise, a clean step moves it, and a
    checkpoint saves, restores verified into a fresh trainer and resumes
    bitwise (the next step equal on both)."""
    cfg = tcfg_small()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, norm="group"))
    trainer = Trainer(cfg, SyntheticDataset(cfg.data, length=4), device="cpu",
                      workdir=str(workdir))
    assert not any("running" in k for k in trainer.model.state_dict())
    _nan_step(trainer, "skip")
    assert trainer.save(kind="scheduled")
    resumed = Trainer(cfg, SyntheticDataset(cfg.data, length=4), device="cpu",
                      workdir=str(workdir))
    assert resumed.restore() == trainer.state.step == 2
    assert _same(_state_snapshot(trainer), _state_snapshot(resumed))
    batch = _epoch_batch(trainer, 9)
    got, want = resumed.train_one_batch(dict(batch)), trainer.train_one_batch(dict(batch))
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert _same(_state_snapshot(trainer), _state_snapshot(resumed))


def _epoch_batch(trainer, epoch):
    """The first batch of ``epoch``'s order."""
    trainer.loader.set_epoch(epoch)
    batches = iter(trainer.loader)
    try:
        return next(batches)
    finally:
        batches.close()


def _nan_step(trainer, policy):
    batch = _epoch_batch(trainer, 7)
    batch["image"] = batch["image"].copy()
    batch["image"][0, 3, 3, 0] = np.nan  # poisons every gradient downstream
    before = _state_snapshot(trainer)
    saved = _state_snapshot(trainer)
    step = trainer.state.step
    trainer.config = trainer.config.replace(
        train=dataclasses.replace(trainer.config.train, nonfinite_policy=policy))
    trainer.step_fn = make_train_step(trainer.config)
    trainer.skip_monitor = fault.SkipMonitor(policy)
    try:
        if policy == "halt":
            with pytest.raises(NonFiniteEscalation):
                trainer.train_one_batch(batch)
        else:
            m = trainer.train_one_batch(batch)
    finally:
        trainer.config = trainer.config.replace(
            train=dataclasses.replace(trainer.config.train, nonfinite_policy="skip"))
        trainer.step_fn = make_train_step(trainer.config)
        trainer.skip_monitor = fault.SkipMonitor("skip")
    assert trainer.state.step == step + 1
    if policy == "apply":
        after = trainer.model.state_dict()
        assert not torch.isfinite(after["trunk.conv1.weight"]).all()
        assert float(m["skipped"]) == 0.0
        trainer.model.load_state_dict(saved[0])  # leave the shared trainer clean
        trainer.state.optimizer.load_state_dict(saved[1])
        return
    assert _same(before, _state_snapshot(trainer))  # bit-identical, BN buffers too
    if policy == "skip":
        m = {k: float(v) for k, v in m.items()}  # device scalars: read here
        assert m["skipped"] == 1.0 and m["nonfinite_count"] > 0
        assert np.isnan(m["update_norm"]) and np.isfinite(m["param_norm"])
        clean = trainer.train_one_batch(_epoch_batch(trainer, 8))
        assert float(clean["skipped"]) == 0.0 and not _same(before, _state_snapshot(trainer))
