"""Parity of the PyTorch port's training path with the JAX package at a small
size, on the CPU: ResNet18 at 96x96, batch 2, compute float32, the budgets of
``__graft_entry__._dryrun_body`` (pre_nms_train 192 -> 48, RPN n_sample 64,
ROI n_sample 16, max_boxes 4).

The JAX step keys its sampling with threefry; the port's step takes the same
uniforms, computed here in JAX from the step's own keys
(``fold_in(rng, step)`` -> split in 3 -> ``fold_in(key, image)`` -> split ->
``uniform``) and injected. Tolerances, with their reasons:

* The four losses: rtol 1e-5 (observed ~5e-7). XLA:CPU and PyTorch sum the
  convolutions and BatchNorm statistics in different orders.
* Parameters after one Adam step: within 2.5 * lr of the JAX step's, the
  bound the JAX package's own parity tests use. Adam's first update is
  ~lr * sign(grad), so a gradient entry near zero whose sign differs in the
  last bits moves its parameter 2 * lr the other way.
* BatchNorm running statistics: rtol 1e-3 / atol 1e-5 (sums in other orders).
* Train-mode BatchNorm alone against flax: rtol 1e-5 / atol 1e-5 in float32;
  one bfloat16 ulp (rtol 2**-7) in bfloat16.
* Losses alone: rtol 1e-6 (``logsumexp`` rounds differently).
"""

import copy
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.data.loader import collate as j_collate
from replication_faster_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from replication_faster_rcnn_tpu.models.head import select_class_deltas as j_select
from replication_faster_rcnn_tpu.train import create_train_state
from replication_faster_rcnn_tpu.train import losses as j_losses
from replication_faster_rcnn_tpu.train.train_step import host_schedule as j_host_schedule
from replication_faster_rcnn_tpu.train.train_step import make_optimizer as j_make_optimizer
from replication_faster_rcnn_tpu.train.train_step import make_train_step as j_make_train_step
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch.data.loader import collate
from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from replication_faster_rcnn_tpu_torch.models.convert import from_flax_variables
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
from replication_faster_rcnn_tpu_torch.models.head import select_class_deltas
from replication_faster_rcnn_tpu_torch.models.resnet import BatchNorm
from replication_faster_rcnn_tpu_torch.ops import roi_ops
from replication_faster_rcnn_tpu_torch.ops.roi_ops import extract_roi_features
from replication_faster_rcnn_tpu_torch.train import losses
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

SIZE = (96, 96)
LR = 1e-4
LOSSES = ("loss", "rpn_cls_loss", "rpn_reg_loss", "head_cls_loss", "head_reg_loss")


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


def tcfg_small(**train):
    cfg = small(tconfig, tconfig.get_config("voc12_resnet18_align"))
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
    weights, the same batch and the JAX step's draws."""
    jcfg = small(jconfig, jconfig.get_config("voc12_resnet18_align"))
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, dataset="synthetic"))
    tcfg = tcfg_small()
    tx, _ = j_make_optimizer(jcfg, steps_per_epoch=1)
    jmodel, state = create_train_state(jcfg, jax.random.PRNGKey(0), tx)
    jbatch = j_collate([JSyntheticDataset(jcfg.data, length=2)[i] for i in range(2)])
    batch = collate([SyntheticDataset(tcfg.data, length=2)[i] for i in range(2)])
    assert all(np.array_equal(batch[k], jbatch[k]) for k in batch)
    new_state, jmetrics = jax.jit(j_make_train_step(jmodel, jcfg, tx))(state, jbatch)

    model = build_model(tcfg, device="cpu", state_dict=from_flax_variables(_np_vars(state)))
    optimizer, scheduler = make_optimizer(tcfg, model.parameters(), 1)
    ts = TrainState(model, optimizer, scheduler, torch.Generator().manual_seed(0))
    draws = jax_step_draws(state, 2, 6 * 6 * 9, 48 + 4)
    tbatch = {k: t(batch[k]) for k in ("image", "boxes", "labels", "mask")}
    record = {}
    metrics = make_train_step(tcfg)(ts, tbatch, draws=draws, record=record)
    return {
        "jmetrics": {k: float(v) for k, v in jmetrics.items()},
        "jnew": from_flax_variables(_np_vars(new_state)),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "state": ts, "record": record, "draws": draws, "batch": tbatch, "tcfg": tcfg,
    }


def test_train_step_losses_match_jax(one_step):
    got, want = one_step["metrics"], one_step["jmetrics"]
    for k in LOSSES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k in ("n_pos_rpn", "n_pos_head", "nonfinite_count", "skipped"):
        assert got[k] == want[k], k
    assert got["n_pos_rpn"] > 0 and got["n_pos_head"] > 0
    np.testing.assert_allclose(got["param_norm"], want["param_norm"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["update_norm"], want["update_norm"], rtol=1e-3)
    assert one_step["record"]["draws"] is not one_step["draws"]
    assert all(torch.equal(one_step["record"]["draws"][k], one_step["draws"][k]) for k in DRAW_NAMES)


def test_train_step_params_within_adam_bound(one_step):
    state = one_step["state"].model.state_dict()
    want = one_step["jnew"]
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
    assert one_step["state"].step == 1 and one_step["state"].scheduler.last_epoch == 1


def test_trunk_gets_a_gradient_through_roi_align(one_step):
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


def test_losses_match_jax():
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


def test_select_class_deltas_matches_jax():
    rng = np.random.default_rng(2)
    reg = rng.normal(0, 1, (2, 16, 21 * 4)).astype(np.float32)
    labels = rng.integers(-1, 21, (2, 16))
    want = np.asarray(j_select(jnp.asarray(reg), jnp.asarray(labels)))
    np.testing.assert_array_equal(select_class_deltas(t(reg), t(labels)).numpy(), want)


def test_schedule_matches_jax():
    jcfg = jconfig.get_config("voc12_resnet18_align").replace(
        train=jconfig.TrainConfig(lr=1e-3, n_epoch=4))
    cfg = tconfig.get_config("voc12_resnet18_align").replace(
        train=tconfig.TrainConfig(lr=1e-3, n_epoch=4))
    want = j_host_schedule(jcfg, 3)
    got = host_schedule(cfg, 3)
    optimizer, scheduler = make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))], 3)
    for step in range(16):
        np.testing.assert_allclose(got(step), want(step), rtol=1e-15)
        np.testing.assert_allclose(optimizer.param_groups[0]["lr"], want(step), rtol=1e-12)
        optimizer.step()
        scheduler.step()


# ------------------------------------------------------- guarded update, trainer


def _state_snapshot(trainer):
    model = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt = trainer.state.optimizer.state_dict()
    opt_t = [v.clone() for s in opt["state"].values() for v in s.values() if torch.is_tensor(v)]
    return model, opt_t, trainer.state.scheduler.last_epoch


def _same(a, b):
    ma, oa, la = a
    mb, ob, lb = b
    return (la == lb and all(torch.equal(ma[k], mb[k]) for k in ma)
            and all(torch.equal(x, y) for x, y in zip(oa, ob)))


@pytest.fixture(scope="module")
def trainer_and_batches():
    cfg = tcfg_small()
    trainer = Trainer(cfg, SyntheticDataset(cfg.data, length=4), device="cpu")
    history = trainer.train(3)
    return trainer, history


def test_trainer_three_steps_finite(trainer_and_batches):
    trainer, history = trainer_and_batches
    assert len(history) == 3 and trainer.state.step == 3
    for m in history:
        assert all(np.isfinite(m[k]) for k in LOSSES) and m["skipped"] == 0.0
        assert m["lr"] == pytest.approx(LR, rel=1e-2)
    assert trainer.steps_per_epoch == 2 and trainer.model.training


def test_guarded_update_on_a_nan_gradient(trainer_and_batches):
    trainer, _ = trainer_and_batches
    for policy in ("skip", "halt", "apply"):
        _nan_step(trainer, policy)


def _nan_step(trainer, policy):
    batch = next(trainer.batches(7))
    batch["image"] = batch["image"].copy()
    batch["image"][0, 3, 3, 0] = np.nan  # poisons every gradient downstream
    before = _state_snapshot(trainer)
    saved = ({k: v.clone() for k, v in trainer.model.state_dict().items()},
             copy.deepcopy(trainer.state.optimizer.state_dict()),
             trainer.state.scheduler.state_dict())
    step = trainer.state.step
    trainer.config = trainer.config.replace(
        train=dataclasses.replace(trainer.config.train, nonfinite_policy=policy))
    trainer.step_fn = make_train_step(trainer.config)
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
    assert trainer.state.step == step + 1
    if policy == "apply":
        after = trainer.model.state_dict()
        assert not torch.isfinite(after["trunk.conv1.weight"]).all()
        assert m["skipped"] == 0.0
        trainer.model.load_state_dict(saved[0])  # leave the shared trainer clean
        trainer.state.optimizer.load_state_dict(saved[1])
        trainer.state.scheduler.load_state_dict(saved[2])
        return
    assert _same(before, _state_snapshot(trainer))  # bit-identical, BN buffers too
    if policy == "skip":
        assert m["skipped"] == 1.0 and m["nonfinite_count"] > 0
        assert np.isnan(m["update_norm"]) and np.isfinite(m["param_norm"])
        clean = trainer.train_one_batch(next(trainer.batches(8)))
        assert clean["skipped"] == 0.0 and not _same(before, _state_snapshot(trainer))
