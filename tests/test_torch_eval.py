"""The port's evaluation and logging modules against the JAX package's
(`hosnerf_tpu_torch/eval/{io,metrics,renderers}.py`, `utils/tb_writer.py`,
`utils/file_util.py`), on the CPU without compiling a model.

The sweeps run both packages on one deterministic stub renderer (rgb a
fixed function of each ray) over each package's own mini capture, and the
returned results must agree (1e-6), except PSNR and SSIM, which are
held to the same formulas in f64 instead. On these renders JAX's f32
PSNR sits up to 1.14e-6 (relative) from the f64 value and the port's
1.3e-7, so both are held to it within 2e-6; their f32 SSIM sit up to
7.6e-5 (JAX) and 2.8e-5 (the port) from it, as the captures' flat
backgrounds make var = E[x^2] - E[x]^2 cancel, so both are held within
1e-4. The JAX package writes lossy .jpg
files, so the port's PNGs are held to `to_8b_image` of the stub's render
and of the target, pixel for pixel. The metrics are held to JAX's at
1e-6 on seeded images, and the TensorBoard event bytes must equal the
JAX writer's.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hosnerf_tpu.data import scene_loader as jscene_loader
from hosnerf_tpu.data import scene_pipeline as jscene_pipeline
from hosnerf_tpu.data import synthetic as jsynthetic
from hosnerf_tpu.data.human_dataset import HumanDataset as JHumanDataset
from hosnerf_tpu.eval import io as jio
from hosnerf_tpu.eval import metrics as jM
from hosnerf_tpu.eval import renderers as jrend
from hosnerf_tpu.utils import file_util as jfile_util
from hosnerf_tpu.utils import tb_writer as jtb
from hosnerf_tpu_torch.data import imgproc, scene_loader, scene_pipeline
from hosnerf_tpu_torch.data import synthetic
from hosnerf_tpu_torch.data.human_dataset import HumanDataset
from hosnerf_tpu_torch.eval import io as eio
from hosnerf_tpu_torch.eval import metrics as M
from hosnerf_tpu_torch.eval import renderers as rend
from hosnerf_tpu_torch.models import lpips
from hosnerf_tpu_torch.utils import file_util, tb_writer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
# each package's f32 PSNR and SSIM of a sweep to the f64 value
REF_TOL = {"psnr": 2e-6, "ssim": 1e-4}

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(24, 20, 3), (2, 17, 23, 3)])
def test_psnr_matches_jax(shape):
    a, b = _pair(shape, 0)
    got = float(M.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jM.psnr(jnp.asarray(a), jnp.asarray(b)))
    assert got == pytest.approx(want, rel=TOL)


@pytest.mark.parametrize("window", [dict(), dict(kernel_size=7,
                                                 uniform_window=True)])
@pytest.mark.parametrize("shape", [(24, 20, 3), (2, 17, 23, 3)])
def test_ssim_matches_jax(shape, window):
    a, b = _pair(shape, 1)
    got = M.ssim(torch.from_numpy(a), torch.from_numpy(b), **window).numpy()
    want = np.asarray(jM.ssim(jnp.asarray(a), jnp.asarray(b), **window))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_ssim_of_an_image_with_itself_is_one():
    a, _ = _pair((32, 32, 3), 2)
    t = torch.from_numpy(a)
    assert float(M.ssim(t, t)[0]) == pytest.approx(1.0, abs=1e-5)


def test_lpips_metric_is_the_models_mean_on_minus_one_one():
    model = lpips.LPIPS(seed=3, device="cpu")
    metric = M.make_lpips_metric(model)
    a, b = _pair((2, 16, 16, 3), 3)
    with torch.no_grad():
        want = model(torch.from_numpy(a) * 2 - 1,
                     torch.from_numpy(b) * 2 - 1).mean()
    assert torch.equal(metric(a, b), want)          # arrays taken too
    one = metric(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    with torch.no_grad():
        assert torch.equal(one, model(torch.from_numpy(a[:1]) * 2 - 1,
                                      torch.from_numpy(b[:1]) * 2 - 1)[0])


# ---------------------------------------------------------------------------
# TensorBoard events, file helpers, io
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag,value,step,wall", [
    ("train/loss", 0.25, 7, 1.7e9), ("train/psnr", 31.5, 123456, 1.7e9 + .5),
    ("train/lr", -1e-30, 0, 0.0), ("x" * 200, float("inf"), 2 ** 40, 3.25)])
def test_tb_event_bytes_equal_jax(tag, value, step, wall):
    assert tb_writer.encode_scalar_event(tag, value, step, wall) == \
        jtb.encode_scalar_event(tag, value, step, wall)
    rec = tb_writer.frame_record(tb_writer.encode_file_version_event(wall))
    assert rec == jtb.frame_record(jtb.encode_file_version_event(wall))
    data = tag.encode()
    assert tb_writer.crc32c(data) == jtb.crc32c(data)


def test_tb_writer_file_equals_jax(tmp_path, monkeypatch):
    files = []
    for mod, d in ((tb_writer, tmp_path / "port"), (jtb, tmp_path / "jax")):
        clock = iter(np.arange(1.7e9, 1.7e9 + 100, 0.25).tolist())
        monkeypatch.setattr("time.time", lambda: next(clock))
        w = mod.TBWriter(str(d))
        for step in range(3):
            w.add_scalar("train/loss", 1.0 / (step + 1), step)
            w.add_scalar("train/sec_per_step", 0.05 * step, step)
        w.close()
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], "rb") as f, open(files[1], "rb") as g:
        assert f.read() == g.read()


def test_file_util_matches_jax(tmp_path):
    for name in ("b.png", "a.png", "c.jpg", "d.txt"):
        (tmp_path / name).write_text("x")
    for exts in ((".png",), (".png", ".jpg"), (".npz",)):
        assert file_util.list_files(str(tmp_path), exts) == \
            jfile_util.list_files(str(tmp_path), exts)
    for p in ("/a/b/c.tar.gz", "rel/x", "y.png"):
        assert file_util.split_path(p) == jfile_util.split_path(p)


def test_io_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    imgs = [rng.uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32)
            for _ in range(5)]
    for img in imgs:
        np.testing.assert_array_equal(eio.to_8b_image(img),
                                      jio.to_8b_image(img))
    u8 = [jio.to_8b_image(i) for i in imgs]
    for per_row in (1, 2, 4):
        np.testing.assert_array_equal(eio.tile_images(u8, per_row),
                                      jio.tile_images(u8, per_row))
    stats = ({"psnr": np.float32(20.5), "ssim": 0.5, "lpips": None,
              "is_empty_img": False}, {"train": 1.0, "val": None})
    eio.write_stats(str(tmp_path / "a.json"), *stats)
    jio.write_stats(str(tmp_path / "b.json"), *stats)
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()


def test_store_image_writes_the_8bit_pixels(tmp_path):
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(-0.2, 1.2, (6, 9, 3)).astype(np.float32)
            for _ in range(3)]
    paths = eio.store_image(str(tmp_path / "vis"), imgs)
    assert [os.path.basename(p) for p in paths] == [
        "image000.png", "image001.png", "image002.png"]
    for p, img in zip(paths, imgs):
        np.testing.assert_array_equal(imgproc.imread_png(p, color=True),
                                      eio.to_8b_image(img)[..., ::-1])
    # uint8 images as they are (the sweeps' [render | target] tiles)
    u8 = eio.to_8b_image(imgs[0])
    p, = eio.store_image(str(tmp_path / "u8"), [u8])
    np.testing.assert_array_equal(imgproc.imread_png(p, color=True),
                                  u8[..., ::-1])


def test_store_video_without_an_encoder_names_the_file(tmp_path,
                                                       monkeypatch):
    frames = [np.zeros((8, 8, 3), np.float32)] * 2
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="images.mp4"):
        eio.store_video(str(tmp_path / "v"), frames)


# ---------------------------------------------------------------------------
# the sweeps, on a stub renderer
# ---------------------------------------------------------------------------

def _stub_rgb(rays_o, rays_d):
    """The stub renderer: rgb in [0.1, 0.9], a fixed function of a ray."""
    return (0.5 + 0.4 * np.sin(3.0 * rays_d + rays_o)).astype(np.float32)


def port_render(b):
    return torch.from_numpy(_stub_rgb(b["rays_o"].numpy(),
                                      b["rays_d"].numpy()))


def jax_render(params, b):
    return jnp.asarray(_stub_rgb(np.asarray(b["rays_o"]),
                                 np.asarray(b["rays_d"])))


def port_scene_step(b):
    return torch.from_numpy(_stub_rgb(b["rays_o"].numpy(),
                                      b["viewdirs"].numpy()))


def jax_scene_step(params, b):
    return jnp.asarray(_stub_rgb(np.asarray(b["rays_o"]),
                                 np.asarray(b["viewdirs"])))


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """Each package's own mini capture (10 frames of 32 x 32), its scene
    loaded by the package's loader."""
    root = tmp_path_factory.mktemp("eval_caps")
    out = {}
    for name, syn, loader in (("port", synthetic, scene_loader),
                              ("jax", jsynthetic, jscene_loader)):
        syn.write_mini_dataset(str(root / name / "mini"), n_frames=10,
                               res=32)
        scene = loader.load_nerf_360_v2(str(root / name), "mini", factor=1,
                                        near=0.2, far=30.0)
        out[name] = (str(root / name / "mini"), scene)
    return out


def _factory(cls, path):
    def factory(mode, **kw):
        return cls(path, mode=mode, mweight_volume_size=8,
                   bgcolor=[255.0, 255.0, 255.0], **kw)
    return factory


def _ssim64(a, b, kernel_size=11, sigma=1.5, uniform_window=False):
    """The SSIM formula of both packages in f64 (numpy, the separable
    'valid' window written out), on one [H, W, 3] pair."""
    if uniform_window:
        k = np.full(kernel_size, 1.0 / kernel_size)
    else:
        x = np.arange(kernel_size) - (kernel_size - 1) / 2.0
        g = np.exp(-(x ** 2) / (2 * sigma ** 2))
        k = (g / g.sum()).astype(np.float32).astype(np.float64)
    n = len(k)

    def filt(t):
        h, w = t.shape[:2]
        t = sum(k[i] * t[i:h - n + 1 + i] for i in range(n))
        return sum(k[j] * t[:, j:w - n + 1 + j] for j in range(n))

    a, b = a.astype(np.float64), b.astype(np.float64)
    mx, my = filt(a), filt(b)
    vx, vy = filt(a * a) - mx ** 2, filt(b * b) - my ** 2
    cov = filt(a * b) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return float(np.mean(((2 * mx * my + c1) * (2 * cov + c2))
                         / ((mx ** 2 + my ** 2 + c1) * (vx + vy + c2))))


def _item_rgb(item):
    h, w = item["img_height"], item["img_width"]
    return _stub_rgb(item["rays_o"], item["rays_d"]).reshape(h, w, 3)


def _ref64(pairs, **window):
    """{'psnr', 'ssim'}: the f64 means over (render, target) pairs."""
    return {"psnr": float(np.mean([
                -10.0 * np.log10(np.mean((a.astype(np.float64) - b) ** 2))
                for a, b in pairs])),
            "ssim": float(np.mean([_ssim64(a, b, **window)
                                   for a, b in pairs]))}


def _human_ref(ds, n=None, render=_item_rgb):
    """The f64 PSNR and SSIM (uniform 7 window) of a sweep over ds."""
    items = [ds[i] for i in range(len(ds) if n is None else n)]
    return _ref64([(render(it), it["target_img"]) for it in items],
                  kernel_size=7, uniform_window=True)


def _close(got, want, what, ref):
    """Two results dicts equal: floats to TOL, the rest exactly, but
    'psnr' and 'ssim' each within REF_TOL of `ref` (the f64 values, or
    dicts of them by split)."""
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        if k in REF_TOL:
            pairs = ([(got[k], ref[k]), (v, ref[k])] if not isinstance(v, dict)
                     else [(side[s], ref[k][s]) for side in (got[k], v)
                           for s in v])
            for a, r in pairs:
                assert a == pytest.approx(r, rel=REF_TOL[k]), (what, k, a, r)
        elif isinstance(v, dict):
            _close(got[k], v, f"{what}.{k}", ref)
        elif isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=TOL, abs=TOL), (what, k)
        else:
            assert got[k] == v, (what, k)


def _assert_pngs_are_the_render(dirpath, items, extra=()):
    """The port's [render | target] PNGs: to_8b_image of the stub's
    image beside the item's target, pixel for pixel."""
    files = sorted(os.listdir(dirpath))
    assert len(files) == len(items)
    for f, item in zip(files, items):
        h, w = item["img_height"], item["img_width"]
        rgb = _stub_rgb(item["rays_o"], item["rays_d"]).reshape(h, w, 3)
        want = np.concatenate([eio.to_8b_image(rgb),
                               eio.to_8b_image(item["target_img"])], 1)
        got = imgproc.imread_png(os.path.join(dirpath, f), color=True)
        np.testing.assert_array_equal(got[..., ::-1], want)


def test_evaluate_human_matches_jax(tmp_path, captures):
    (path, _), (jpath, _) = captures["port"], captures["jax"]
    ds = _factory(HumanDataset, path)(mode="test")
    jds = _factory(JHumanDataset, jpath)(mode="test")
    for max_items in (None, 2):
        got = rend.evaluate_human(port_render, ds, str(tmp_path / "p"),
                                  "testimgs", max_items=max_items,
                                  device="cpu")
        want = jrend.evaluate_human(jax_render, None, jds,
                                    str(tmp_path / "j"), "testimgs",
                                    max_items=max_items)
        _close(got, want, "evaluate_human", _human_ref(ds, max_items))
        assert got["is_empty_img"] is False
    _assert_pngs_are_the_render(str(tmp_path / "p" / "testimgs_vis"),
                                [ds[i] for i in range(len(ds))])
    with open(tmp_path / "p" / "results_testimgs.json") as f:
        assert json.load(f) == [got]


def test_evaluate_human_empty_trap(tmp_path, captures):
    """A render within 5/255 of the background everywhere is flagged, in
    both packages; one 6/255 off is not."""
    (path, _), (jpath, _) = captures["port"], captures["jax"]
    ds = _factory(HumanDataset, path)(mode="progress")
    jds = _factory(JHumanDataset, jpath)(mode="progress")
    for off, empty in ((4.0, True), (6.0, False)):
        shade = (255.0 - off) / 255.0

        def prender(b, shade=shade):
            return torch.full((b["rays_o"].shape[0], 3), shade)

        def jrender(p, b, shade=shade):
            return jnp.full((b["rays_o"].shape[0], 3), shade)

        got = rend.evaluate_human(prender, ds, str(tmp_path), "prog",
                                  max_items=2, save_images=False,
                                  device="cpu")
        want = jrend.evaluate_human(jrender, None, jds, str(tmp_path),
                                    "jprog", max_items=2, save_images=False)
        assert got["is_empty_img"] is want["is_empty_img"] is empty
        _close(got, want, "empty trap", _human_ref(
            ds, 2, lambda it, v=shade: np.full_like(it["target_img"], v)))


def test_full_human_eval_matches_jax(tmp_path, captures, monkeypatch):
    """The whole sweep: the results, the freeview and tpose frames (each
    package's store_video and store_image calls captured) and
    results.json."""
    (path, _), (jpath, _) = captures["port"], captures["jax"]
    seen = {"port": [], "jax": []}
    for key, mod in (("port", eio), ("jax", jio)):
        for fn in ("store_video", "store_image"):
            orig = getattr(mod, fn)

            def spy(d, frames, *a, _o=orig, _k=key, **kw):
                seen[_k].append((os.path.basename(d),
                                 [np.asarray(x) for x in frames]))
                return _o(d, frames, *a, **kw)
            monkeypatch.setattr(mod, fn, spy)
    kw = dict(freeview_frames=3, tpose_views=2, tpose_resolution=16)
    trans = HumanDataset(path, mode="train").transitions
    got = rend.full_human_eval(port_render, _factory(HumanDataset, path),
                               str(tmp_path / "p"), transitions=trans,
                               device="cpu", **kw)
    want = jrend.full_human_eval(jax_render, None,
                                 _factory(JHumanDataset, jpath),
                                 str(tmp_path / "j"), transitions=trans,
                                 **kw)
    assert got.keys() == want.keys()
    pf = _factory(HumanDataset, path)
    for tag, mode in (("testimgs", "test"), ("allimgs", "movement")):
        _close(got[tag], want[tag], tag, _human_ref(pf(mode=mode)))
    assert [d for d, _ in seen["port"]] == [d for d, _ in seen["jax"]] == [
        "testimgs_vis", "allimgs_vis", "freeview", "tpose_vis"]
    for (d, a), (_, b) in zip(seen["port"], seen["jax"]):
        assert len(a) == len(b), d
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=TOL, err_msg=d)
    assert len(seen["port"][3][1]) == 2 * 2     # 2 views x 2 states
    with open(tmp_path / "p" / "results.json") as f:
        assert json.load(f) == [got["testimgs"], got["allimgs"]]


def test_render_freeview_and_tpose_match_jax(tmp_path, captures):
    (path, _), (jpath, _) = captures["port"], captures["jax"]
    pf, jf = _factory(HumanDataset, path), _factory(JHumanDataset, jpath)
    got = rend.render_freeview(port_render, pf("freeview", render_frames=2),
                               str(tmp_path), save_video=False, device="cpu")
    want = jrend.render_freeview(jax_render, None,
                                 jf("freeview", render_frames=2),
                                 str(tmp_path), save_video=False)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL)
    # more than 8 views per state: an mp4 per state and 8 sheet views
    got = rend.render_tpose(port_render, pf("tpose", render_frames=9),
                            str(tmp_path / "p"), transitions=[0.5],
                            resolution=12, device="cpu")
    want = jrend.render_tpose(jax_render, None, jf("tpose", render_frames=9),
                              str(tmp_path / "j"), transitions=[0.5],
                              resolution=12)
    assert len(got) == len(want) == 16
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL)
    assert os.path.isfile(tmp_path / "p" / "tpose_state1" / "images.mp4")


@pytest.mark.parametrize("transitions", [None, [], [0.3], [0.25, 0.6]])
def test_tpose_midpoint_times_match_jax(transitions):
    arg = None if transitions is None else np.asarray(transitions)
    assert rend.tpose_midpoint_times(arg) == jrend.tpose_midpoint_times(arg)


def test_evaluate_scene_matches_jax(tmp_path, captures):
    pipe = scene_pipeline.ScenePipeline(captures["port"][1], 128, seed=0)
    jpipe = jscene_pipeline.ScenePipeline(captures["jax"][1], 128, seed=0)
    got = rend.evaluate_scene(port_scene_step, pipe, str(tmp_path / "p"),
                              chunk=300, device="cpu")
    want = jrend.evaluate_scene(jax_scene_step, None, jpipe,
                                str(tmp_path / "j"), chunk=300)
    i_train, i_val, i_test, _ = pipe.scene.i_split
    refs = {split: _ref64([(rend.render_scene_image(
        port_scene_step, pipe, int(i), device="cpu"),
        pipe.scene.images[int(i)]) for i in ids])
        for split, ids in (("train", i_train), ("val", i_val),
                           ("test", i_test))}
    _close(got, want, "evaluate_scene",
           {k: {s: r[k] for s, r in refs.items()} for k in REF_TOL})
    img = rend.render_scene_image(port_scene_step, pipe, 3, chunk=300,
                                  device="cpu")
    np.testing.assert_allclose(img, jrend.render_scene_image(
        jax_scene_step, None, jpipe, 3, chunk=300), atol=TOL)
    with open(tmp_path / "p" / "results.json") as f:
        assert json.load(f) == [got["psnr"], got["ssim"], got["lpips"]]
    files = sorted(os.listdir(tmp_path / "p" / "render_model"))
    assert len(files) == len(pipe.scene.i_split[2])
    i = int(pipe.scene.i_split[2][0])
    np.testing.assert_array_equal(
        imgproc.imread_png(str(tmp_path / "p" / "render_model" / files[0]),
                           color=True)[..., ::-1],
        eio.to_8b_image(rend.render_scene_image(port_scene_step, pipe, i,
                                                device="cpu")))


def test_render_scene_path_matches_jax(tmp_path, captures, monkeypatch):
    frames = {}
    for key, mod in (("port", eio), ("jax", jio)):
        def spy(d, fr, *a, _k=key, **kw):
            frames[_k] = [np.asarray(x) for x in fr]
            return os.path.join(d, "images.mp4")
        monkeypatch.setattr(mod, "store_video", spy)
    pipe = scene_pipeline.ScenePipeline(captures["port"][1], 128, seed=0)
    jpipe = jscene_pipeline.ScenePipeline(captures["jax"][1], 128, seed=0)
    path = rend.render_scene_path(port_scene_step, pipe, str(tmp_path),
                                  chunk=700, device="cpu")
    jrend.render_scene_path(jax_scene_step, None, jpipe, str(tmp_path),
                            chunk=700)
    assert path == os.path.join(str(tmp_path), "render_video", "images.mp4")
    assert len(frames["port"]) == len(frames["jax"]) == len(
        pipe.scene.render_poses)
    for a, b in zip(frames["port"], frames["jax"]):
        np.testing.assert_allclose(a, b, atol=TOL)


def test_new_modules_import_without_jax():
    code = ("import sys\n"
            "import hosnerf_tpu_torch.cli.run, hosnerf_tpu_torch.train.loop, "
            "hosnerf_tpu_torch.train.checkpoints, "
            "hosnerf_tpu_torch.eval.io, hosnerf_tpu_torch.eval.metrics, "
            "hosnerf_tpu_torch.eval.renderers, hosnerf_tpu_torch.utils, "
            "hosnerf_tpu_torch.utils.file_util, "
            "hosnerf_tpu_torch.utils.tb_writer, "
            "hosnerf_tpu_torch.tools.blend_bwd_f64\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'triton', 'hosnerf_tpu', 'cv2', "
            "'imageio', 'yaml')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
