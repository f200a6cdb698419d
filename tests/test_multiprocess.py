"""Real multi-process distributed run (SURVEY §4 (d)).

Launches 2 jax.distributed CPU processes (coordinator on localhost, 4 virtual
devices each) running tests/mp_worker.py, then asserts the multi-process
encode_batch / encode_mosaic / decode_batch outputs are byte-/bit-identical
to this process's single-process 8-virtual-device results. This exercises
make_multihost_mesh, cross-process device ordering, host_to_global sharding
and the process_allgather host assembly for real — the seams a virtual mesh
cannot reach.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_outputs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("mp")
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)  # worker pins cpu via jax.config
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "mp_worker.py"),
             f"127.0.0.1:{port}", "2", str(pid), str(outdir)],
            env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            pytest.fail(f"worker rc={p.returncode}\n{out[-4000:]}")
    return outdir


def test_multiprocess_encode_batch_byte_identical(mp_outputs):
    from jpeg_tpu.parallel.batch import encode_batch
    from jpeg_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, size=(4, 64, 48, 3)).astype(np.uint8)
    ref = encode_batch(imgs, quality=75, mesh=make_mesh(8, batch_axis=2))
    for i, r in enumerate(ref):
        got = (mp_outputs / f"img{i}.jpg").read_bytes()
        assert got == r, f"image {i} differs across process counts"


def test_multiprocess_mosaic_byte_identical(mp_outputs):
    from jpeg_tpu.parallel.mesh import make_mesh
    from jpeg_tpu.parallel.mosaic import encode_mosaic

    rng = np.random.default_rng(7)
    rng.integers(0, 256, size=(4, 64, 48, 3))  # keep the stream aligned
    big = rng.integers(0, 256, size=(256, 80, 3)).astype(np.uint8)
    ref = encode_mosaic(big, quality=80, mesh=make_mesh(8, batch_axis=1))
    got = (mp_outputs / "mosaic.jpg").read_bytes()
    assert got == ref


def test_multiprocess_decode_batch_bit_identical(mp_outputs):
    from jpeg_tpu.models.decoder import decode

    got = np.load(mp_outputs / "decoded.npy")
    for i in range(got.shape[0]):
        ref = decode((mp_outputs / f"img{i}.jpg").read_bytes())
        np.testing.assert_array_equal(got[i], ref)
