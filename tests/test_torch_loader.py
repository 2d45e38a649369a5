"""The stage-1 input pipeline of the PyTorch port against the JAX package:
the C++ loader (native/loader.py, the port's own copy of cxr_loader.cpp),
its Python route, ``preprocess_file``, ``preprocess_cxr_batch``,
``DevicePrefetcher`` on the CPU, ``pad_text_batch``, ``stage1_raw_batches``
and ``Stage1Data`` (the JAX one reads the CSVs with pandas).

Everything is held bitwise (crops, orders, token arrays, records) except
``preprocess_cxr_batch``, which is ``preprocess_cxr`` of each image in one
batched resize: rtol = atol = 1e-5 against JAX's, float32 resampling in
another order. The images are the committed fixtures tests/fixtures/cxr/
(written by make_fixtures.py there). With one worker thread the native
loader emits in shuffle order; with several, in the order workers finish,
so those runs are compared by index.
"""
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from radialog_tpu.data import datasets as jds
from radialog_tpu.data import prefetch as jpf
from radialog_tpu.data.tokenization import WhitespaceTokenizer as JTok
from radialog_tpu.native import loader as jl
from radialog_tpu.ops import image as jimg
from radialog_tpu_torch.apps.tokenization import WhitespaceTokenizer as TTok
from radialog_tpu_torch.data import datasets as tds
from radialog_tpu_torch.data import prefetch as tpf
from radialog_tpu_torch.native import loader as tl
from radialog_tpu_torch.ops import image as timg
from test_torch_datasets import _write_crafted

CXR = sorted(str(p) for p in (Path(__file__).resolve().parent / "fixtures" / "cxr").glob("*.jpg"))


def _epoch(mod, paths, seed=4, **kw):
    kw = {"batch": 3, "resize": 96, "crop": 80, "threads": 1, "shuffle": True, "seed": 1, **kw}
    with mod.CxrLoader(paths, **kw) as ld:
        out = list(ld.epoch(seed=seed))
    return out, ld


def test_fixtures_are_small_synthetic_grays():
    assert len(CXR) == 8
    assert sum(Path(p).stat().st_size for p in CXR) <= 300 * 1024
    im = timg.load_image_grayscale(CXR[0])
    assert im.dtype == np.uint8 and min(im.shape) >= 500


def test_native_builds_into_build_native():
    assert tl.native_available(), tl.build_error()
    path = tl.library_path()
    assert path.exists() and path.parent.parts[-2:] == ("build", "native")
    assert tl.build_native() is tl.build_native()


@pytest.mark.parametrize("emit_u8", [True, False])
def test_native_route_bitwise_against_jax(emit_u8):
    want, _ = _epoch(jl, CXR, emit_u8=emit_u8)
    got, ld = _epoch(tl, CXR, emit_u8=emit_u8)
    assert ld.route == "native"
    assert [i.tolist() for _, i in got] == [i.tolist() for _, i in want]
    assert sorted(i for _, idx in got for i in idx) == list(range(len(CXR)))
    for (g, _), (w, _) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # several threads: the same crop for every index, in some order
    many, _ = _epoch(tl, CXR, emit_u8=emit_u8, threads=4)
    by_index = {int(i): im for ims, idx in want for i, im in zip(idx, ims)}
    assert sorted(by_index) == sorted(int(i) for _, idx in many for i in idx)
    for ims, idx in many:
        for i, im in zip(idx, ims):
            np.testing.assert_array_equal(im, by_index[int(i)])


def test_uint8_crops_are_the_f32_route_over_255():
    u8, _ = _epoch(tl, CXR, emit_u8=True)
    f32, _ = _epoch(tl, CXR, emit_u8=False)
    for (a, _), (b, _) in zip(u8, f32):
        np.testing.assert_array_equal(timg.expand_cxr_u8(torch.from_numpy(a)).numpy(), b)


@pytest.mark.parametrize("emit_u8", [True, False])
def test_python_route_against_jax(monkeypatch, emit_u8):
    monkeypatch.setattr(jl, "build_native", lambda force=False: None)
    monkeypatch.setattr(tl, "build_native", lambda force=False: None)
    want, _ = _epoch(jl, CXR[:5], emit_u8=emit_u8, threads=2)
    got, ld = _epoch(tl, CXR[:5], emit_u8=emit_u8, threads=3)
    assert ld.route == "pil"
    assert [i.tolist() for _, i in got] == [i.tolist() for _, i in want]
    for (g, _), (w, _) in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("route", ["native", "pil"])
def test_bad_file_skipped(tmp_path, monkeypatch, route):
    if route == "pil":
        monkeypatch.setattr(tl, "build_native", lambda force=False: None)
    bad = tmp_path / "broken.jpg"
    bad.write_bytes(b"not a jpeg")
    paths = CXR[:3] + [str(bad)] + CXR[3:5]
    got, ld = _epoch(tl, paths, batch=4, shuffle=False, emit_u8=True)
    assert ld.route == route
    assert [i.tolist() for _, i in got] == [[0, 1, 2, 4], [5]]


def test_preprocess_file_both_routes(monkeypatch):
    for p in CXR[:2]:
        np.testing.assert_array_equal(tl.preprocess_file(p, 256, 224),
                                      jl.preprocess_file(p, 256, 224))
        monkeypatch.setattr(tl, "build_native", lambda force=False: None)
        np.testing.assert_array_equal(
            tl.preprocess_file(p, 256, 224),
            jimg.preprocess_cxr_np(jimg.load_image_grayscale(p), 256, 224))
        monkeypatch.undo()


def test_preprocess_cxr_batch_against_jax():
    imgs = np.stack([jimg.load_image_grayscale(p)[:560, :540] for p in CXR[:3]])
    want = np.asarray(jimg.preprocess_cxr_batch(imgs, resize=96, crop=80))
    got = timg.preprocess_cxr_batch(torch.from_numpy(imgs), resize=96, crop=80)
    assert got.shape == (3, 80, 80, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for i in range(3):
        torch.testing.assert_close(got[i], timg.preprocess_cxr(torch.from_numpy(imgs[i]), 96, 80),
                                   rtol=0, atol=0)


# ------------------------------------------------------------ the prefetcher
def test_prefetcher_yields_every_batch_as_tensors():
    src = [{"images": np.full((2, 4, 4), i, np.uint8), "text_ids": np.arange(6).reshape(2, 3),
            "name": f"b{i}"} for i in range(7)]
    with tpf.DevicePrefetcher(iter(src), depth=2, device="cpu") as pf:
        got = list(pf)
    assert len(got) == 7 and pf.staged == 7 and len(pf.waits_s) == 7
    for i, b in enumerate(got):
        assert isinstance(b["images"], torch.Tensor) and int(b["images"][0, 0, 0]) == i
        assert b["name"] == f"b{i}"
        assert b["text_ids"].data_ptr() == torch.as_tensor(src[i]["text_ids"]).data_ptr()


def test_prefetcher_reraises_a_source_error():
    def src():
        yield {"x": np.zeros(2)}
        raise RuntimeError("decode failed")

    pf = tpf.DevicePrefetcher(src(), device="cpu")
    it = iter(pf)
    assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    pf.close()


def test_prefetcher_close_mid_stream_returns():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield {"x": np.full(3, i)}
            i += 1

    pf = tpf.DevicePrefetcher(endless(), depth=2, device="cpu")
    it = iter(pf)
    assert [int(next(it)["x"][0]) for _ in range(3)] == [0, 1, 2]
    t0 = time.time()
    pf.close()
    assert time.time() - t0 < 5 and not pf._thread.is_alive()
    n = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == n            # the source is no longer pulled
    assert threading.active_count() < 50


# ----------------------------------------------------- text and raw batches
def test_pad_text_batch_against_jax():
    ids = [[101, 5, 6, 7], [101] + list(range(10, 30)), [], [101, 9]]
    for max_len, rows in ((8, None), (8, 6), (25, None)):
        for g, w in zip(tpf.pad_text_batch(ids, max_len, rows), jpf.pad_text_batch(ids, max_len,
                                                                                   rows)):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def _stage1_tree(root: Path, mod):
    """The fixture JPEGs under a MIMIC-like tree, with CSVs for 8 studies."""
    img_root = root / "images"
    split, sect = ["dicom_id,split"], ["findings,dicom_id,Img_Folder,Img_Filename,Note_file"]
    for i, p in enumerate(CXR):
        folder = f"files/p10/p100000{i:02d}/s5000000{i}"
        (img_root / folder).mkdir(parents=True)
        shutil.copy(p, img_root / folder / f"d{i}.jpg")
        split.append(f"d{i},train")
        sect.append(f'"Finding {i} here.\nsecond line {i % 3}",d{i},{folder},d{i}.jpg,s{i}.txt')
    (root / "split.csv").write_text("\n".join(split) + "\n")
    (root / "sectioned.csv").write_text("\n".join(sect) + "\n")
    return mod.MimicPaths(split_csv=str(root / "split.csv"),
                          sectioned_csv=str(root / "sectioned.csv"), chexpert_csv="",
                          image_root=str(img_root))


@pytest.mark.parametrize("raw_u8,drop_last", [(True, True), (False, False)])
def test_stage1_raw_batches_against_jax(tmp_path, raw_u8, drop_last):
    out = []
    for mod, dsm, tok in ((jpf, jds, JTok(vocab_size=128)), (tpf, tds, TTok(vocab_size=128))):
        data = dsm.Stage1Data(_stage1_tree(tmp_path / mod.__name__, dsm), split="train",
                              custom_epochs_per_epoch=2)
        out.append(list(mod.stage1_raw_batches(data, tok, 6, batch=3, sub_epoch=1, resize=96,
                                               crop=80, threads=1, seed=2,
                                               drop_last=drop_last, raw_u8=raw_u8)))
    want, got = out
    assert len(got) == len(want) == (1 if drop_last else 2)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["images", "text_ids", "text_mask"]
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("chexpert", [True, False])
@pytest.mark.parametrize("split,truncate,epochs", [("test", None, None), ("test", 5, None),
                                                   ("test", None, 3), ("train", None, None),
                                                   ("validate", None, 2)])
def test_stage1_data_against_pandas(tmp_path, split, truncate, epochs, chexpert):
    _write_crafted(tmp_path)
    datas = []
    for mod in (jds, tds):
        paths = mod.MimicPaths(split_csv=str(tmp_path / "split.csv"),
                               sectioned_csv=str(tmp_path / "sectioned.csv"),
                               chexpert_csv=str(tmp_path / "chexpert.csv") if chexpert else "",
                               image_root="/data/mimic" if epochs else None)
        datas.append(mod.Stage1Data(paths, split=split, truncate=truncate,
                                    custom_epochs_per_epoch=epochs))
    want, got = datas
    assert len(got) == len(want) and got.custom_epochs_per_epoch == want.custom_epochs_per_epoch
    assert got.img_ids == want.img_ids
    for sub in range(got.custom_epochs_per_epoch + 1):
        want.set_custom_epoch(sub)
        got.set_custom_epoch(sub)
        assert [got[i] for i in range(len(got))] == [want[i] for i in range(len(want))]
