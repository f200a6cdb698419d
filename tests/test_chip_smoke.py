"""CPU tests of chip_smoke.py's helpers: byte/pixel comparison, the plain
encode reference, the compile-cache rule and the no-GPU exit — plus guards
that the removed TPU-only kernels and their options stay gone."""

import ast
import inspect
import pathlib

import numpy as np
import pytest

import chip_smoke
from jpeg_tpu import decode, encode, encode_batched
from jpeg_tpu.utils import synth

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("got, want, off", [
    (b"abc", b"abc", None),
    (b"abc", b"abd", 2),
    (b"xbc", b"abc", 0),
    (b"ab", b"abc", 2),
    (b"abcd", b"abc", 3),
    (b"", b"", None),
])
def test_first_mismatch(got, want, off):
    assert chip_smoke.first_mismatch(got, want) == off


def test_require_same_bytes_names_the_offset():
    chip_smoke.require_same_bytes("same", b"\xff\xd8", b"\xff\xd8")
    with pytest.raises(AssertionError, match="offset 1"):
        chip_smoke.require_same_bytes("jpg", b"\xff\xd9", b"\xff\xd8")


def test_pixel_delta():
    a = np.zeros((4, 5, 3), np.uint8)
    b = a.copy()
    assert chip_smoke.pixel_delta(a, b) == (0, 0.0)
    b[0, 0, 0] = 1
    b[3, 4, 2] = 255
    dmax, share = chip_smoke.pixel_delta(a, b)
    assert dmax == 255 and share == pytest.approx(2 / a.size)
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.pixel_delta(a, b[:3])


def test_psnr_chunked_matches_direct(rng):
    a = rng.integers(0, 256, (37, 11, 3)).astype(np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-3, 4, a.shape), 0, 255)
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    assert chip_smoke.psnr_chunked(a, b, rows=5) == pytest.approx(
        10 * np.log10(255.0 ** 2 / mse))
    assert chip_smoke.psnr_chunked(a, a) == float("inf")


@pytest.fixture
def exact_encoder(monkeypatch):
    """Route encode() through the integer transform, as every accelerator
    backend does (the CPU backend's default is the staged float form), so its
    bytes can be compared with reference_encode on the CPU."""
    from jpeg_tpu.models import encoder as E
    from jpeg_tpu.ops import mcu_conv

    builders = (E._jit_color, E._jit_color_packed, E._jit_color_hists,
                E._jit_gray, E._jit_gray_packed, E._jit_gray_hists)
    for b in builders:
        b.cache_clear()
    monkeypatch.setattr(mcu_conv, "mcu_transform",
                        mcu_conv._mcu_transform_int)
    monkeypatch.setattr(E, "_transform_gray", mcu_conv.gray_transform_int)
    yield
    monkeypatch.undo()
    for b in builders:
        b.cache_clear()


@pytest.mark.parametrize("kw", [
    dict(quality=75, subsampling="420"),
    dict(quality=95, subsampling="420"),
    dict(quality=75, subsampling="422"),
    dict(quality=75, subsampling="444"),
    dict(quality=80, subsampling="440"),
    dict(quality=75, subsampling="420", restart_interval=3),
    dict(quality=75, subsampling="420", optimize_tables=True),
    dict(quality=75, gray=True),
    dict(quality=70, gray=True, restart_interval=5, optimize_tables=True),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("device_pack", [False, True])
def test_reference_encode_matches_encoder(exact_encoder, kw, device_pack):
    """chip_smoke's plain reference (integer transform on the CPU device +
    NumPy entropy coder) equals encode() byte for byte on both packers, at
    an odd size that needs edge padding."""
    kw = dict(kw)
    img = synth.photo(37, 53, seed=3, gray=kw.pop("gray", False))
    want = chip_smoke.reference_encode(img, **kw)
    assert encode(img, device_pack=device_pack, **kw) == want
    assert decode(want).shape[:2] == img.shape[:2]


def test_reference_encode_matches_batched(exact_encoder):
    imgs = np.stack([synth.photo(32, 48, seed=s) for s in range(3)])
    want = [chip_smoke.reference_encode(im, 75, "420") for im in imgs]
    assert encode_batched(imgs, quality=75, device_pack=True) == want


def test_compile_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert chip_smoke.compile_cache_dir("/elsewhere") == str(tmp_path)


def test_compile_cache_dir_default_is_fixed(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert chip_smoke.compile_cache_dir() == str(REPO / ".jax_cache")
    assert chip_smoke.compile_cache_dir("/r") == "/r/.jax_cache"


@pytest.mark.parametrize("env_set", [False, True])
def test_use_compile_cache_overrides_only_unset(monkeypatch, tmp_path,
                                               env_set):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = chip_smoke.use_compile_cache(str(tmp_path / "repo"))
    if env_set:
        assert path == str(tmp_path) and calls == []
    else:
        want = str(tmp_path / "repo" / ".jax_cache")
        assert path == want
        assert calls == [("jax_compilation_cache_dir", want)]


def test_main_without_gpu_exits_nonzero_and_prints_nothing(capsys):
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def _python_files():
    skip = {".git", ".jax_cache", "chiprun_out", "__pycache__", ".hypothesis"}
    for p in REPO.rglob("*.py"):
        if not skip.intersection(p.relative_to(REPO).parts):
            yield p


def test_no_module_imports_pallas_tpu():
    """The TPU-only Pallas kernels are gone: nothing imports
    jax.experimental.pallas.tpu (or jax.experimental.pallas's tpu)."""
    bad = []
    for path in _python_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                continue
            if any(n.startswith("jax.experimental.pallas.tpu")
                   for n in names):
                bad.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not bad, bad


@pytest.mark.parametrize("fn", [encode, decode])
def test_pallas_options_removed(fn):
    params = inspect.signature(fn).parameters
    assert not {"use_pallas", "use_pallas_pack", "pallas_pack"} & set(params)
