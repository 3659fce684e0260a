"""The port's data path (``qavit_tpu_torch/data/``) against the JAX
package's (``qavit_tpu/data/``) on the same numpy inputs: the procedural
substrates bit for bit, the caches both ways, the dataset fallbacks, the
pipelines and presets field for field, every augmentation op under
``jax.vmap`` with the same per-image parameters, the composed
``proc100_hard_hqa`` pipeline, the draws' distributions, the loaders'
orders and the evaluate CLI on a tiny cached substrate.

Stated tolerances, on the [0, 255] pixel scale:
- resample, photometric and blur ops: 1e-3 x 255 absolute (float32 sums
  in another order; the port computes per-image transcendental scalars in
  float64 and rounds once);
- crop, flip, posterize, solarize, equalize and erasing: exact on
  integer-valued inputs (selections and integer arithmetic);
- the normalised output of the whole composed pipeline: 2e-3 absolute;
- ``eval_batch`` with the 32 -> 224 resize: 1e-4 absolute (normalised).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qavit_tpu.configs import get_preset as jax_get_preset
from qavit_tpu.data import augment as JA
from qavit_tpu.data import datasets as JD
from qavit_tpu.data import loader as JL
from qavit_tpu.data import pipelines as JPL
from qavit_tpu.data import procgen as JP
from qavit_tpu_torch.configs import get_preset
from qavit_tpu_torch.data import augment as TA
from qavit_tpu_torch.data import datasets as TD
from qavit_tpu_torch.data import loader as TL
from qavit_tpu_torch.data import pipelines as TPL
from qavit_tpu_torch.data import procgen as TP

PIXEL_TOL = 1e-3 * 255.0
COMPOSED_TOL = 2e-3
RESIZE_TOL = 1e-4
SUBSTRATE_PRESETS = ("hqavit_proc100", "hqavit_proc100_hard",
                     "hqavit_proc100_hard_finetune", "hqavit_tiny_proc10")


# ---------------------------------------------------------------------------
# procedural substrates, caches, datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, kw", [
    (7, dict()), (7, dict(hard=True)),
    (5, dict(img_size=64, num_classes=200)), (4, dict(img_size=96)),
    (3, dict(img_size=224))], ids=["easy32", "hard32", "tin64", "stl96",
                                   "px224"])
def test_generate_proc100_is_bit_identical(n, kw):
    """Several generation batches (batch < n): the same RandomState calls
    in the same order give the same arrays."""
    xj, yj = JP.generate_proc100(n, seed=3, batch=2, **kw)
    xt, yt = TP.generate_proc100(n, seed=3, batch=2, **kw)
    assert xt.dtype == np.uint8 and yt.dtype == np.int32
    assert np.array_equal(xt, xj) and np.array_equal(yt, yj)


LOADERS = ("proc100", "proc100_hard", "proc10", "proc_tin", "proc224",
           "proc_stl", "proc_stl50k")


@pytest.mark.parametrize("name", LOADERS)
def test_loaders_keep_their_seeds_and_cache(name, tmp_path):
    """Each ``load_or_generate_*`` at a small n: the port's arrays and
    cache equal the JAX package's (seeds, sizes, classes, npz keys)."""
    n = 2 if name in ("proc224", "proc_stl50k") else 4
    fj = getattr(JP, f"load_or_generate_{name}")
    ft = getattr(TP, f"load_or_generate_{name}")
    aj = fj(str(tmp_path / "jax"), n_train=n, n_test=2)
    at = ft(str(tmp_path / "port"), n_train=n, n_test=2)
    for a, b in zip(at, aj):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    zj = np.load(tmp_path / "jax" / f"{name}.npz")
    zt = np.load(tmp_path / "port" / f"{name}.npz")
    assert sorted(zt.files) == sorted(zj.files) == [
        "test_images", "test_labels", "train_images", "train_labels"]


def test_caches_are_interchangeable(tmp_path):
    """A small proc100_hard cache written by JAX's loader is read by the
    port's ``load_dataset``, and one written by the port by JAX's (read,
    not regenerated: the default sizes are 50k / 10k)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    JP.load_or_generate_proc100_hard(a, n_train=6, n_test=4)
    TP.load_or_generate_proc100_hard(b, n_train=5, n_test=3)
    for root, n in ((a, 6), (b, 5)):
        dt, dj = (TD.load_dataset("proc100_hard", root),
                  JD.load_dataset("proc100_hard", root))
        assert len(dt.train_labels) == n and dt.num_classes == 100
        assert not dt.synthetic
        for f in ("train_images", "train_labels", "test_images",
                  "test_labels"):
            assert np.array_equal(getattr(dt, f), getattr(dj, f))


READER_FILES = {"cifar10": "cifar-10-batches-py/data_batch_1",
                "cifar100": "cifar-100-python/train",
                "stl10": "stl10_binary/train_X.bin",
                "stl10_unlabeled": "stl10_binary/train_X.bin",
                "tiny_imagenet": "tiny-imagenet-200.zip"}


@pytest.mark.parametrize("name", sorted(READER_FILES))
def test_reader_datasets_fall_back_where_jax_does(name, tmp_path,
                                                  monkeypatch):
    """Files absent: the synthetic set of the JAX package's sizes (the
    sets themselves are held equal in test_torch_port_model.py and
    test_torch_port_tin.py).  Files present: the port raises (their
    readers are not ported), never synthetic data."""
    calls = []
    monkeypatch.setattr(JD, "_synthetic", lambda *a: calls.append(a) or a)
    monkeypatch.setattr(TD, "synthetic_dataset",
                        lambda *a: calls.append(a) or a)
    TD.load_dataset(name, str(tmp_path))
    JD.load_dataset(name, str(tmp_path))
    assert len(calls) == 2 and calls[0] == calls[1]
    with pytest.raises(FileNotFoundError):
        TD.load_dataset(name, str(tmp_path), allow_synthetic=False)
    marker = tmp_path / READER_FILES[name]
    marker.parent.mkdir(parents=True, exist_ok=True)
    marker.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        TD.load_dataset(name, str(tmp_path))


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        TD.load_dataset("imagenet")
    with pytest.raises(KeyError):
        TPL.get_pipeline("proc100_hard")
    with pytest.raises(KeyError):
        get_preset("qavit_v2_extreme_proc100")


def test_stats_and_subsample_per_class_match_jax():
    assert TD.STATS == JD.STATS
    rng = np.random.RandomState(5)
    ds = dict(name="x", train_images=rng.randint(0, 256, (40, 2, 2, 3),
                                                 ).astype(np.uint8),
              train_labels=rng.randint(0, 7, 40).astype(np.int32),
              test_images=np.zeros((1, 2, 2, 3), np.uint8),
              test_labels=np.zeros(1, np.int32), num_classes=7)
    st = TD.subsample_per_class(TD.Dataset(**ds), 3)
    sj = JD.subsample_per_class(JD.Dataset(**ds), 3)
    assert np.array_equal(st.train_images, sj.train_images)
    assert np.array_equal(st.train_labels, sj.train_labels)


@pytest.mark.parametrize("name", sorted(JPL.PIPELINES))
def test_pipeline_matches_jax(name):
    assert sorted(TPL.PIPELINES) == sorted(JPL.PIPELINES)
    assert (dataclasses.asdict(TPL.get_pipeline(name))
            == dataclasses.asdict(JPL.get_pipeline(name)))


@pytest.mark.parametrize("name", SUBSTRATE_PRESETS)
def test_substrate_preset_matches_jax(name):
    pj, pt = jax_get_preset(name), get_preset(name)
    assert dataclasses.asdict(pt.model) == dataclasses.asdict(pj.model)
    assert dataclasses.asdict(pt.train) == dataclasses.asdict(pj.train)
    assert pt.dataset == pj.dataset
    TPL.get_pipeline(pt.dataset)


@pytest.mark.parametrize("name", ["hqavit_proc100_hard_finetune",
                                  "hqavit_tiny_proc10"])
def test_transfer_presets_train_step_waits_for_lr_groups(name):
    from qavit_tpu_torch.train.steps import make_train_step

    p = get_preset(name)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        make_train_step(p.model, p.train, lambda step: 0.0)


# ---------------------------------------------------------------------------
# augmentation ops, with the same per-image parameters as JAX's
# ---------------------------------------------------------------------------

B, H = 6, 12
# the composed pipeline's batch: 16 images of 16 px
CB, CH = 16, 16
RANDAUG_MAGNITUDE = 10.0
RRC_SCALE = (0.2, 1.0)
ERASING = dict(prob=0.5, scale=(0.02, 0.4), ratio=(0.3, 3.3))


def _images(seed=0, size=H, b=B):
    """Integer-valued float32 images [B, H, W, 3] in [0, 255]."""
    return np.random.RandomState(seed).randint(
        0, 256, (b, size, size, 3)).astype(np.float32)


def _signed(lo, hi, seed=2):
    return np.random.RandomState(seed).uniform(lo, hi, B).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# name -> (JAX op on one image and one parameter, port op on the batch,
#          its parameters [B])
PARAM_OPS = {
    "shear_x": (JA.shear_x, TA.shear_x, _signed(-0.3, 0.3)),
    "shear_y": (JA.shear_y, TA.shear_y, _signed(-0.3, 0.3)),
    "translate_x": (JA.translate_x, TA.translate_x, _signed(-5, 5)),
    "translate_y": (JA.translate_y, TA.translate_y, _signed(-5, 5)),
    "rotate": (JA.rotate, TA.rotate, _signed(-30, 30)),
    "brightness": (JA.adjust_brightness, TA.adjust_brightness,
                   _signed(0.1, 1.9)),
    "contrast": (JA.adjust_contrast, TA.adjust_contrast, _signed(0.1, 1.9)),
    "saturation": (JA.adjust_saturation, TA.adjust_saturation,
                   _signed(0.1, 1.9)),
    "hue": (JA.adjust_hue, TA.adjust_hue, _signed(-0.5, 0.5)),
    "sharpness": (JA.sharpness, TA.sharpness, _signed(0.1, 1.9)),
}
# name -> (JAX op, port op, constant argument, exact on integer inputs)
CONST_OPS = {
    "posterize7": (JA.posterize, TA.posterize, 7, True),
    "posterize4": (JA.posterize, TA.posterize, 4, True),
    "solarize": (JA.solarize, TA.solarize, 170.0, True),
    "autocontrast": (lambda im, _: JA.autocontrast(im),
                     lambda im, _: TA.autocontrast(im), None, False),
    "equalize": (lambda im, _: JA.equalize(im),
                 lambda im, _: TA.equalize(im), None, True),
}


def _const_images():
    img = _images()
    img[0, :, :, 1] = 77.0              # a flat channel (step 0)
    img[1] = np.minimum(img[1], 30.0)   # a narrow histogram
    return img


def _erasing_draws(k, h, prob, scale, ratio):
    """The draws of JAX's ``random_erasing`` from key ``k``."""
    r_do, r_area, r_ratio, r_y, r_x, r_val = jax.random.split(k, 6)
    return dict(
        do=jax.random.bernoulli(r_do, prob),
        area=jax.random.uniform(r_area, (), minval=scale[0], maxval=scale[1]),
        log_ratio=jax.random.uniform(r_ratio, (), minval=jnp.log(ratio[0]),
                                     maxval=jnp.log(ratio[1])),
        oy=jax.random.randint(r_y, (), 0, h),
        ox=jax.random.randint(r_x, (), 0, h),
        noise=jax.random.normal(r_val, (h, h, 3), jnp.float32))


def _image_params(k, cfg, h):
    """``augment_image``'s draws from key ``k`` (proc100_hard_hqa's
    steps), replaying its splits in its order, as the port's parameters
    (plus JAX's erasing noise)."""
    p = {}
    k, r = jax.random.split(k)
    ry, rx = jax.random.split(r)
    p["crop_y"] = jax.random.randint(ry, (), 0, 2 * cfg.crop_pad + 1)
    p["crop_x"] = jax.random.randint(rx, (), 0, 2 * cfg.crop_pad + 1)
    k, r = jax.random.split(k)
    p["flip"] = jax.random.bernoulli(r)
    k, r = jax.random.split(k)
    p["rot_deg"] = jax.random.uniform(r, (), minval=-cfg.rotation_deg,
                                      maxval=cfg.rotation_deg)
    b, c, s, hue = cfg.jitter
    k, r_do, rb, rc, rs, rh = jax.random.split(k, 6)
    p["jitter_b"] = jax.random.uniform(rb, (), minval=1 - b, maxval=1 + b)
    p["jitter_c"] = jax.random.uniform(rc, (), minval=1 - c, maxval=1 + c)
    p["jitter_s"] = jax.random.uniform(rs, (), minval=1 - s, maxval=1 + s)
    p["jitter_h"] = jax.random.uniform(rh, (), minval=-hue, maxval=hue)
    p["jitter_do"] = jax.random.bernoulli(r_do, cfg.jitter_prob)
    k, r = jax.random.split(k)
    ops, signs = [], []
    for _ in range(cfg.randaug_ops):
        r, r_op, r_apply = jax.random.split(r, 3)
        ops.append(jax.random.randint(r_op, (), 0, 14))
        signs.append(jnp.where(jax.random.bernoulli(r_apply), 1.0, -1.0))
    p["ra_op"], p["ra_sign"] = jnp.stack(ops), jnp.stack(signs)
    k, r = jax.random.split(k)
    e = _erasing_draws(r, h, cfg.erasing_prob, cfg.erasing_scale,
                       cfg.erasing_ratio)
    p.update(erase_do=e["do"], erase_area=e["area"],
             erase_log_ratio=e["log_ratio"], erase_y=e["oy"],
             erase_x=e["ox"])
    return p, e["noise"]


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX-side output of the op tests, vmapped over the images and
    computed by one jit: each op with its parameters, the draws of the
    ops that take a key, the 14 RandAugment branches, and the composed
    proc100_hard_hqa pipeline (``augment_image``) with its draws."""
    cfg = JPL.get_pipeline("proc100_hard_hqa").aug

    def refs(img, cimg, params, keys, ckeys):
        out = {}
        for name, (jop, _, _) in PARAM_OPS.items():
            out[name] = jax.vmap(jop)(img, params[name])
        for name, (jop, _, arg, _) in CONST_OPS.items():
            out[name] = jax.vmap(lambda im: jop(im, arg))(cimg)
        out["crop"] = jax.vmap(lambda k, im: JA.random_crop(k, im, 4))(
            keys, img)
        out["crop_yx"] = jax.vmap(lambda k: jnp.stack([
            jax.random.randint(r, (), 0, 9) for r in jax.random.split(k)]))(
            keys)
        out["hflip"] = jax.vmap(JA.hflip)(keys, img)
        out["flip"] = jax.vmap(jax.random.bernoulli)(keys)
        out["rrc"] = jax.vmap(lambda k, im: JA.random_resized_crop(
            k, im, RRC_SCALE))(keys, img)

        def rrc_draws(k):
            r_area, r_ratio, r_y, r_x = jax.random.split(k, 4)
            return jnp.stack([
                jax.random.uniform(r_area, (), minval=RRC_SCALE[0],
                                   maxval=RRC_SCALE[1]),
                jax.random.uniform(r_ratio, (), minval=jnp.log(3 / 4),
                                   maxval=jnp.log(4 / 3)),
                jax.random.uniform(r_y, ()), jax.random.uniform(r_x, ())])

        out["rrc_draws"] = jax.vmap(rrc_draws)(keys)
        out["blur"] = jax.vmap(lambda k, im: JA.gaussian_blur(k, im, 3))(
            keys, img)
        out["sigma"] = jax.vmap(lambda k: jax.random.uniform(
            k, (), minval=0.1, maxval=2.0))(keys)
        ekeys = jnp.concatenate([keys, ckeys])[:CB]
        eimg = jnp.concatenate([img, img, img])[:CB] / 64.0 - 2.0
        out["erasing_in"] = eimg
        out["erasing"] = jax.vmap(lambda k, im: JA.random_erasing(
            k, im, ERASING["prob"], ERASING["scale"], ERASING["ratio"]))(
            ekeys, eimg)
        out["erasing_draws"] = jax.vmap(lambda k: _erasing_draws(
            k, H, **ERASING))(ekeys)
        out["sign"] = jax.vmap(jax.random.bernoulli)(keys)
        # the 14 branches in one vmapped switch: image i of copy op
        ops = jnp.repeat(jnp.arange(TA.RANDAUG_OPS), B)
        out["randaug"] = jax.vmap(lambda k, im, op: JA._randaug_apply(
            k, im, op, RANDAUG_MAGNITUDE))(
            jnp.tile(keys, (TA.RANDAUG_OPS, 1)),
            jnp.tile(img, (TA.RANDAUG_OPS, 1, 1, 1)), ops).reshape(
            (TA.RANDAUG_OPS,) + img.shape)
        out["composed"] = jax.vmap(lambda k, im: JA.augment_image(
            k, im, cfg))(ckeys, cimg_u8)
        out["composed_params"], out["composed_noise"] = jax.vmap(
            lambda k: _image_params(k, cfg, CH))(ckeys)
        return out

    cimg_u8 = jnp.asarray(_images(seed=4, size=CH, b=CB).astype(np.uint8))
    args = (jnp.asarray(_images()), jnp.asarray(_const_images()),
            {k: jnp.asarray(v[2]) for k, v in PARAM_OPS.items()},
            jax.random.split(jax.random.PRNGKey(1), B),
            jax.random.split(jax.random.PRNGKey(5), CB))
    # LLVM's optimisation off: the program runs once on tiny arrays, and
    # its compile is most of this file's time
    out = jax.jit(refs).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    out = jax.tree_util.tree_map(np.asarray, out)
    out["composed_in"] = np.asarray(cimg_u8)
    return out


def _check(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and np.isfinite(got).all()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=PIXEL_TOL)


@pytest.mark.parametrize("name", sorted(PARAM_OPS))
def test_parametrised_op_matches_jax(name, jax_ref):
    _, top, param = PARAM_OPS[name]
    _check(top(_t(_images()), _t(param)), jax_ref[name], False)


@pytest.mark.parametrize("name", sorted(CONST_OPS))
def test_batch_constant_op_matches_jax(name, jax_ref):
    _, top, arg, exact = CONST_OPS[name]
    _check(top(_t(_const_images()), arg), jax_ref[name], exact)


def test_crop_and_flip_match_jax(jax_ref):
    oy, ox = _t(jax_ref["crop_yx"]).long().unbind(-1)
    _check(TA.crop(_t(_images()), oy, ox, 4), jax_ref["crop"], True)
    _check(TA.hflip(_t(_images()), _t(jax_ref["flip"])), jax_ref["hflip"],
           True)


def test_resized_crop_matches_jax(jax_ref):
    got = TA.resized_crop(_t(_images()), *_t(jax_ref["rrc_draws"]).unbind(-1))
    _check(got, jax_ref["rrc"], False)


def test_gaussian_blur_matches_jax(jax_ref):
    _check(TA.gaussian_blur(_t(_images()), _t(jax_ref["sigma"]), 3),
           jax_ref["blur"], False)


def test_erasing_matches_jax(jax_ref):
    """The box (corner anywhere, clipped by the image, not moved) exactly,
    given JAX's draws; p = 0.5, so both branches occur.  The fill is JAX's
    noise, drawn a second time in the same program (XLA may fuse the two
    draws differently: 1e-6 inside the box)."""
    d = {k: _t(v) for k, v in jax_ref["erasing_draws"].items()}
    img, want = _t(jax_ref["erasing_in"]), jax_ref["erasing"]
    erased = TA.erase(img, d["area"], d["log_ratio"], d["oy"].long(),
                      d["ox"].long(), d["noise"])
    got = torch.where(d["do"][:, None, None, None], erased, img).numpy()
    assert 0 < int(d["do"].sum()) < CB
    box = got != img.numpy()
    np.testing.assert_array_equal(box, want != img.numpy())
    np.testing.assert_array_equal(got[~box], want[~box])
    np.testing.assert_allclose(got[box], want[box], rtol=0, atol=1e-6)


@pytest.mark.parametrize("op", range(TA.RANDAUG_OPS))
def test_randaug_op_matches_jax(op, jax_ref):
    """Each of the 14 RandAugment branches at magnitude 10, the sign drawn
    as JAX's ``_randaug_apply`` draws it."""
    sign = torch.where(_t(jax_ref["sign"]), 1.0, -1.0)
    _check(TA.randaug_op(_t(_images()), op, sign, RANDAUG_MAGNITUDE),
           jax_ref["randaug"][op], op in (0, 10, 11, 13))


# ---------------------------------------------------------------------------
# the composed pipeline, the draws, eval_batch
# ---------------------------------------------------------------------------

def test_composed_pipeline_matches_jax(jax_ref):
    """proc100_hard_hqa through ``apply_augment`` with JAX's draws against
    ``augment_image``: within 2e-3 outside the erased boxes; inside them
    the port's own noise (the fill's distribution, not JAX's bits)."""
    want, jnoise = jax_ref["composed"], jax_ref["composed_noise"]
    params = {k: _t(v) for k, v in jax_ref["composed_params"].items()}
    for k in ("crop_y", "crop_x", "ra_op", "erase_y", "erase_x"):
        params[k] = params[k].long()
    params["erase_seed"] = torch.arange(CB)
    got = TA.apply_augment(_t(jax_ref["composed_in"]), params,
                           TPL.get_pipeline("proc100_hard_hqa").aug).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    # the boxes, from the port's geometry; JAX filled the same ones with
    # its noise (drawn a second time here: 1e-6, as in the erasing test)
    zero = torch.zeros(got.shape)
    box = (TA.erase(zero, params["erase_area"], params["erase_log_ratio"],
                    params["erase_y"], params["erase_x"], zero + 1).numpy()
           * params["erase_do"].numpy()[:, None, None, None]) > 0
    assert box.any() and not box.all()
    np.testing.assert_allclose(want[box], jnoise[box], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[~box], want[~box], rtol=0,
                               atol=COMPOSED_TOL)
    noise = TA.erase_noise(params["erase_seed"], got.shape[1:]).numpy()
    np.testing.assert_array_equal(got[box], noise[box])
    # the ops were exercised: jitter both ways, the discontinuous ones
    assert set(params["ra_op"].flatten().tolist()) >= {1, 5, 10, 13}
    assert 0 < int(params["jitter_do"].sum()) < CB


def test_draws_are_deterministic_and_match_jax_distributions():
    cfg = TPL.get_pipeline("proc100_hard_hqa").aug
    imgs = torch.from_numpy(_images(seed=6, size=16).astype(np.uint8))
    run = [TA.augment_batch(imgs, cfg, torch.Generator().manual_seed(s))
           for s in (3, 3, 4)]
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])
    n = 4096
    p = TA.draw_params(cfg, n, torch.Generator().manual_seed(0))
    assert all(v.shape[0] == n for v in p.values())

    def within_4_sigma(hits, trials, prob):
        sigma = math.sqrt(trials * prob * (1 - prob))
        assert abs(int(hits) - trials * prob) <= 4 * sigma, (hits, prob)

    within_4_sigma(p["flip"].sum(), n, 0.5)
    within_4_sigma(p["jitter_do"].sum(), n, cfg.jitter_prob)
    within_4_sigma(p["erase_do"].sum(), n, cfg.erasing_prob)
    within_4_sigma((p["ra_sign"] > 0).sum(), p["ra_sign"].numel(), 0.5)
    for op in range(TA.RANDAUG_OPS):
        within_4_sigma((p["ra_op"] == op).sum(), p["ra_op"].numel(), 1 / 14)
    assert set(p["crop_y"].tolist()) == set(range(2 * cfg.crop_pad + 1))
    assert set(p["crop_x"].tolist()) == set(range(2 * cfg.crop_pad + 1))
    for key, (lo, hi) in dict(rot_deg=(-15, 15), jitter_b=(0.5, 1.5),
                              jitter_c=(0.5, 1.5), jitter_s=(0.5, 1.5),
                              jitter_h=(-0.15, 0.15),
                              erase_area=(0.02, 0.4)).items():
        assert lo <= float(p[key].min()) and float(p[key].max()) <= hi, key
        assert float(p[key].max() - p[key].min()) > 0.9 * (hi - lo), key
    z = TA.erase_noise(torch.arange(4), (32, 32, 3))
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1) < 0.05


@pytest.mark.parametrize("name", sorted(TPL.PIPELINES))
def test_every_pipeline_augments(name):
    """``augment_batch`` under each pipeline at its dataset's image size:
    finite, [B, S, S, 3] (S = resize_to or the size), deterministic."""
    pipe = TPL.get_pipeline(name)
    size = TD.SIZES[pipe.base_dataset][0]
    imgs = torch.from_numpy(_images(seed=9, size=size, b=2).astype(np.uint8))
    out = [TA.augment_batch(imgs, pipe.aug, torch.Generator().manual_seed(1))
           for _ in range(2)]
    s = pipe.aug.resize_to or size
    assert out[0].shape == (2, s, s, 3) and out[0].dtype == torch.float32
    assert bool(torch.isfinite(out[0]).all()) and torch.equal(*out)


@pytest.mark.parametrize("pipeline", ["cifar100_224", "proc100_hard_hqa"])
def test_eval_batch_matches_jax(pipeline):
    """[resize +] normalise: the 32 -> 224 bilinear upsampling equals
    ``jax.image.resize``'s."""
    imgs = _images(seed=7, size=32, b=2).astype(np.uint8)
    want = np.asarray(JA.eval_batch(jnp.asarray(imgs),
                                    JPL.get_pipeline(pipeline).aug))
    got = TA.eval_batch(_t(imgs), TPL.get_pipeline(pipeline).aug).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("size, to", [(32, 224), (96, 32), (96, 50)])
def test_resize_matches_jax(size, to):
    """Bilinear resize with half-pixel centres, antialiased when it
    shrinks, against ``jax.image.resize``: 1e-3 on the pixel scale."""
    imgs = _images(seed=10, size=size, b=2)
    want = np.asarray(jax.image.resize(jnp.asarray(imgs), (2, to, to, 3),
                                       "bilinear"))
    got = TA.resize(_t(imgs), to).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# loaders and the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop_last", [True, False])
def test_loaders_yield_jax_order(drop_last):
    imgs = _images(seed=8, size=2, b=23).astype(np.uint8)
    labels = np.arange(23, dtype=np.int32)
    jb = JL.BatchLoader(imgs, labels, 5, seed=3, drop_last=drop_last)
    tb = TL.BatchLoader(imgs, labels, 5, seed=3, drop_last=drop_last)
    ji = JL.IndexLoader(23, 5, seed=3, drop_last=drop_last)
    ti = TL.IndexLoader(23, 5, seed=3, drop_last=drop_last)
    assert len(tb) == len(jb) and len(ti) == len(ji)
    for _ in range(2):                        # two epochs
        got = list(tb)
        want = list(jb)
        assert len(got) == len(want)
        for (xt, yt), (xj, yj) in zip(got, want):
            assert np.array_equal(xt.numpy(), np.asarray(xj))
            assert np.array_equal(yt.numpy(), np.asarray(yj))
        for it, ij in zip(list(ti), list(ji)):
            assert np.array_equal(it.numpy(), ij)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        TL.BatchLoader(imgs, labels, 5, process_count=2, process_index=0)


def test_cli_evaluates_a_cached_substrate(tmp_path):
    """``cli.evaluate`` without ``--synthetic`` on a tiny proc100_hard
    cache: the preset's pipeline, ``load_dataset``, ``eval_batch``."""
    from qavit_tpu_torch.cli import evaluate

    TP.load_or_generate_proc100_hard(str(tmp_path), n_train=8, n_test=12)
    r = evaluate.main(["--preset", "hqavit_proc100_hard", "--data-root",
                       str(tmp_path), "--device", "cpu", "--batch-size", "8",
                       "--batches", "1"])
    assert r["count"] == 8 and math.isfinite(r["loss"])
    assert 0.0 <= r["top1"] <= r["top5"] <= 100.0


@pytest.mark.slow
def test_retained_flagship_through_the_port_data_path():
    """checkpoints_keep/proc100_hard_ft (the record: 93.40 top-1) on the
    10k val split that the port's ``generate_proc100(10000, seed=7,
    hard=True)`` makes, preprocessed by the port's ``eval_batch``, on the
    CPU in bf16: top-1 within 0.1 of JAX's on the same split."""
    from pathlib import Path

    from flax.core import freeze

    from qavit_tpu.ckpt.checkpoint import _restore_numpy
    from qavit_tpu.data import eval_batch as jax_eval_batch
    from qavit_tpu.nn import build_model as jax_build_model
    from qavit_tpu_torch.ckpt.from_jax import load_jax_params
    from qavit_tpu_torch.nn.models import HQAViT

    path = (Path(__file__).resolve().parents[1] / "checkpoints_keep"
            / "proc100_hard_ft" / "state")
    if not path.exists():
        pytest.skip(f"{path} is not in this checkout")
    tree = _restore_numpy(path.resolve())
    x, y = TP.generate_proc100(10000, seed=7, hard=True)
    preset = get_preset("hqavit_proc100_hard_finetune")
    aug = TPL.get_pipeline(preset.dataset).aug
    model = load_jax_params(HQAViT(preset.model), tree["params"],
                            tree["batch_stats"]).eval()
    correct = 0
    with torch.inference_mode():
        for i in range(0, len(y), 500):
            logits, _ = model(TA.eval_batch(_t(x[i:i + 500]), aug))
            correct += int((logits.argmax(-1).numpy() == y[i:i + 500]).sum())
    top1 = 100.0 * correct / len(y)

    jcfg = jax_get_preset("hqavit_proc100_hard_finetune").model
    jmodel = jax_build_model(jcfg)
    jaug = JPL.get_pipeline("proc100_hard_hqa").aug
    variables = freeze({"params": tree["params"],
                        "batch_stats": tree["batch_stats"]})
    fwd = jax.jit(lambda v, im: jmodel.apply(v, jax_eval_batch(im, jaug),
                                             train=False,
                                             bank_count=tree["bank_count"]))
    jcorrect = 0
    for i in range(0, len(y), 500):
        lj, _ = fwd(variables, jnp.asarray(x[i:i + 500]))
        jcorrect += int((np.asarray(lj).argmax(-1) == y[i:i + 500]).sum())
    jtop1 = 100.0 * jcorrect / len(y)
    print(f"proc100_hard_ft on the 10k val split: port {top1:.2f}, JAX "
          f"{jtop1:.2f} (record 93.40)")
    assert abs(top1 - jtop1) <= 0.1
