"""The port's eval/train loaders and native decoder against the JAX
package's, on the CPU: ``native.decode_batch`` / ``decode_batch_u8`` bit
for bit on seeded JPEGs and PNGs; ``StimuliDataset`` batches and keys on
the cache, brick, native, per-item and PIL routes; the cache decision;
a second pass that decodes nothing; ``LabeledDataset.native_batch``'s
flip-only augmentation.

Both packages build the same C++ source with the same g++ flags, so
their decoders agree exactly (tolerance 0). Cases that need the decoder
skip where the JAX package's does not build (no g++ or no libjpeg/libpng
headers), as tests/test_native_decode.py does.
"""
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import visreps_tpu.native as jnative
from visreps_tpu.data import loader as jloader
from visreps_tpu.data.transforms import get_transform as jax_transform

import visreps_tpu_torch.native as tnative
from visreps_tpu_torch.data import loader as tloader
from visreps_tpu_torch.data.transforms import get_transform

# (height, width): downscales of either orientation, an identity resize
# (shorter side 256) and an upscale below the crop.
SIZES = [(300, 400), (256, 320), (500, 333), (256, 256), (120, 90), (231, 260)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread (a parallel test run otherwise
    oversubscribes the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def natives():
    """Skip where the JAX package's decoder does not build."""
    if not jnative.native_available():
        pytest.skip("native fastimage library unavailable (needs g++, libjpeg and libpng)")
    assert tnative.native_available(), tnative.BUILD_ERROR


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Seeded JPEGs and PNGs of SIZES, alternating formats."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        path = root / (f"img{i}.jpg" if i % 2 == 0 else f"img{i}.png")
        Image.fromarray(img).save(path, **({"quality": 90} if i % 2 == 0 else {}))
        paths.append(str(path))
    return paths


def _routes(fn):
    """(fn's result, the items it served by route)."""
    before = Counter(tloader.ROUTES)
    out = fn()
    after = Counter(tloader.ROUTES)
    after.subtract(before)
    return out, +after


def _passes(loader):
    batches = list(loader)
    return np.concatenate([b for b, _ in batches]), [k for _, ks in batches for k in ks]


# ── the decoder ──

@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("kind", ["float", "u8"])
def test_decode_bit_for_bit(natives, images, kind, flip, threads):
    hflip = (np.arange(len(images)) % 2).astype(np.uint8) if flip else None
    if kind == "float":
        kw = dict(mean=(0.48, 0.448, 0.398), std=(0.272, 0.265, 0.274))
        got = tnative.decode_batch(images, 256, 224, hflip=hflip, n_threads=threads, **kw)
        ref = jnative.decode_batch(images, 256, 224, hflip=hflip, n_threads=threads, **kw)
        assert got.dtype == np.float32
    else:
        got = tnative.decode_batch_u8(images, 256, 224, hflip=hflip, n_threads=threads)
        ref = jnative.decode_batch_u8(images, 256, 224, hflip=hflip, n_threads=threads)
        assert got.dtype == np.uint8
    assert got.shape == (len(images), 224, 224, 3)
    np.testing.assert_array_equal(got, ref)


def test_decode_small_crop_and_fast_dct(natives, images):
    """Tiny-ImageNet's 64/64 geometry and the DCT-domain downscale."""
    for fast in (False, True):
        np.testing.assert_array_equal(
            tnative.decode_batch_u8(images, 64, 64, fast_dct=fast),
            jnative.decode_batch_u8(images, 64, 64, fast_dct=fast))


def test_decode_failure_raises(natives, images, tmp_path):
    """An image that does not decode raises (the JAX package's decoder
    returns it zero-filled), for both outputs."""
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    for fn in (tnative.decode_batch, tnative.decode_batch_u8):
        with pytest.raises(RuntimeError, match="failed to decode 2 of 3"):
            fn([images[0], str(bad), str(tmp_path / "missing.png")])
    with pytest.raises(ValueError, match="hflip"):
        tnative.decode_batch_u8(images[:2], hflip=np.ones(3, np.uint8))


# ── StimuliDataset ──

class Store(dict):
    """A stimulus dict that counts item reads."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.reads = Counter()

    def __getitem__(self, key):
        self.reads["item"] += 1
        return super().__getitem__(key)


class Brick(Store):
    """A uint8 store that also reads batches in bulk (as the NSD brick
    does), with or without ``item_spec``."""

    def __init__(self, *args, spec=True, **kwargs):
        super().__init__(*args, **kwargs)
        if not spec:
            self.item_spec = None

    def item_spec(self):
        first = dict.__getitem__(self, next(iter(self)))
        return first.shape, first.dtype

    def get_batch(self, keys):
        self.reads["batch"] += 1
        return np.stack([dict.__getitem__(self, k) for k in keys])


def _brick(n=7, shape=(256, 300, 3), spec=True):
    rng = np.random.RandomState(1)
    return Brick({f"s{i:02d}": rng.randint(0, 256, shape).astype(np.uint8) for i in range(n)},
                 spec=spec)


@pytest.mark.parametrize("route,normalize", [
    ("native", True), ("native", False), ("brick", False), ("brick_no_spec", False),
    ("array", True), ("pil", True), ("pil", False)])
def test_stimuli_dataset_routes(request, images, monkeypatch, route, normalize):
    """The same batches and keys as the JAX package's loader, by the
    route the JAX package takes: native for JPEG/PNG paths, one bulk read
    of a uint8 brick, per item for float arrays, and PIL for paths with
    the native decoder off in both packages."""
    if route == "native":
        request.getfixturevalue("natives")
        stimuli = {f"k{i}": p for i, p in enumerate(images)}
    elif route == "pil":
        monkeypatch.setattr(jnative, "native_available", lambda: False)
        monkeypatch.setattr(tnative, "native_available", lambda: False)
        stimuli = {f"k{i}": p for i, p in enumerate(images)}
    elif route == "array":
        stimuli = _brick()
    else:
        stimuli = _brick(spec=route == "brick")
    ref = _passes(jloader.make_stimuli_loader(stimuli, jax_transform("imgnet", normalize=normalize),
                                              batch_size=4, num_workers=2))
    (got, keys), served = _routes(lambda: _passes(tloader.make_stimuli_loader(
        stimuli, get_transform("imgnet", normalize=normalize), batch_size=4, num_workers=2)))
    assert keys == ref[1] == sorted(stimuli)
    assert got.dtype == ref[0].dtype
    np.testing.assert_array_equal(got, ref[0])
    assert served == {route.removesuffix("_no_spec"): len(stimuli)}


@pytest.mark.parametrize("augment,normalize,cap", [
    (False, False, None), (False, True, None), (False, False, "below"), (False, False, "above"),
    (False, True, "below"), (False, True, "above"), (False, False, "0"), (True, False, None)])
def test_cache_decision(monkeypatch, augment, normalize, cap):
    """Cache on or off as in the JAX package: the whole set under
    VISREPS_DECODE_CACHE_MAX (default 8e9; 0 disables) at crop² · 3 bytes
    an item (× 4 normalised), deterministic transforms only."""
    stimuli = {f"k{i}": f"/x/{i}.jpg" for i in range(10)}
    est = 10 * 224 * 224 * 3 * (4 if normalize else 1)
    if cap is not None:
        value = {"below": str(est - 1), "above": str(est + 1), "0": "0"}[cap]
        monkeypatch.setenv("VISREPS_DECODE_CACHE_MAX", value)
    t = tloader.StimuliDataset(stimuli, get_transform("imgnet", normalize=normalize,
                                                      data_augment=augment))
    j = jloader.StimuliDataset(stimuli, jax_transform("imgnet", normalize=normalize,
                                                      data_augment=augment))
    assert t.cache_enabled == (j._cache is not None)
    assert t.cache_enabled == (not augment and cap in (None, "above"))


class CountingTransform:
    """A transform that counts its calls and keeps the wrapped one's spec."""

    def __init__(self, fn):
        self.fn, self.spec, self.calls = fn, fn.spec, 0

    def __call__(self, x):
        self.calls += 1
        return self.fn(x)


@pytest.mark.parametrize("route", ["native", "brick", "array", "pil"])
def test_second_pass_decodes_nothing(request, images, monkeypatch, route):
    """The second pass of one loader is served from the cache: no store
    read, no transform call, no decode, and the same arrays."""
    normalize = route in ("native", "array", "pil")
    if route == "native":
        request.getfixturevalue("natives")
    if route == "pil":
        monkeypatch.setattr(tnative, "native_available", lambda: False)
    if route in ("native", "pil"):
        stimuli = Store({f"k{i}": p for i, p in enumerate(images)})
    else:
        stimuli = _brick()
    tfm = CountingTransform(get_transform("imgnet", normalize=normalize))
    loader = tloader.make_stimuli_loader(stimuli, tfm, batch_size=4, num_workers=2)
    first, served = _routes(lambda: _passes(loader))
    assert served == {route: len(stimuli)}
    assert loader.dataset.cache_stats() == {"entries": len(stimuli), "bytes": first[0].nbytes}
    reads, calls = Counter(stimuli.reads), tfm.calls
    second, served = _routes(lambda: _passes(loader))
    assert served == {"cache": len(stimuli)}
    assert stimuli.reads == reads and tfm.calls == calls
    np.testing.assert_array_equal(second[0], first[0])
    assert second[1] == first[1]


def test_cache_off_decodes_twice(monkeypatch):
    monkeypatch.setenv("VISREPS_DECODE_CACHE_MAX", "0")
    stimuli = _brick()
    loader = tloader.make_stimuli_loader(stimuli, get_transform("imgnet", normalize=False),
                                         batch_size=4, num_workers=2)
    _, first = _routes(lambda: _passes(loader))
    _, second = _routes(lambda: _passes(loader))
    assert first == second == {"brick": len(stimuli)}
    assert loader.dataset.cache_stats() == {"entries": 0, "bytes": 0}


# ── LabeledDataset ──

def test_labeled_native_augment(natives, images, monkeypatch):
    """With VISREPS_NATIVE_AUGMENT=1, an augmenting transform takes the
    native route with flips from RandomState(0): two batches equal the
    JAX package's (the same flips). Without it both return None."""
    samples = [(p, i, Path(p).name) for i, p in enumerate(images)]
    t = tloader.LabeledDataset(samples, get_transform("imgnet", data_augment=True))
    j = jloader.LabeledDataset(samples, jax_transform("imgnet", data_augment=True))
    assert t.native_batch(range(3)) is None and j.native_batch(range(3)) is None
    monkeypatch.setenv("VISREPS_NATIVE_AUGMENT", "1")
    flipped = False
    for idxs in ([0, 1, 2, 3], [5, 4, 1]):
        (tb, tl), served = _routes(lambda: t.native_batch(idxs, n_threads=2))
        jb, jl = j.native_batch(idxs, n_threads=2)
        np.testing.assert_array_equal(tb, jb)
        assert tl == jl == idxs and served == {"native": len(idxs)}
        plain = tnative.decode_batch([images[i] for i in idxs])
        flipped |= not np.array_equal(tb, plain)
    assert flipped


def test_labeled_native_eligibility(natives, images):
    """Not normalised, or a path that is not a JPEG/PNG: None in both
    packages; a plain transform: the decoder's batch."""
    samples = [(p, i, Path(p).name) for i, p in enumerate(images)]
    u8 = get_transform("imgnet", normalize=False)
    assert tloader.LabeledDataset(samples, u8).native_batch([0]) is None
    odd = [(images[0], 0, "a"), ("/x/b.bmp", 1, "b")]
    assert tloader.LabeledDataset(odd, get_transform("imgnet")).native_batch([0, 1]) is None
    assert jloader.LabeledDataset(odd, jax_transform("imgnet")).native_batch([0, 1]) is None
    batch, labels = tloader.LabeledDataset(samples, get_transform("imgnet")).native_batch([2, 0])
    np.testing.assert_array_equal(batch, jnative.decode_batch([images[2], images[0]]))
    assert labels == [2, 0]
