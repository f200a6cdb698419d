"""Scaling-efficiency report for the sharded encode pipeline.

On GPUs (JAX_PLATFORMS=cuda) this times the sharded packed encode across
mesh shapes (1 device / N devices); on the virtual CPU mesh (the default)
wall-clock is meaningless (all shards share the host's cores), so it also
reports XLA's per-shard cost analysis: the per-device FLOP count of the
compiled stripe program, which must scale as 1/N for the pipeline to be
weak-scaling efficient across devices.

  XLA_FLAGS=--xla_force_host_platform_device_count=8 python tools/scaling_report.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    if not os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jpeg_tpu.config import Subsampling
    from jpeg_tpu.entropy import huffman
    from jpeg_tpu.ops import bitpack, quant
    from jpeg_tpu.parallel import shard
    from jpeg_tpu.parallel.mesh import make_mesh

    ndev = len(jax.devices())
    mode = Subsampling.YUV420
    h, w = 256, 256
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(2, h, w, 3)).astype(np.uint8)
    qy, qc = quant.luma_table(75), quant.chroma_table(75)
    huff_tables = huffman.standard_tables()
    luts = tuple(jnp.asarray(a) for a in bitpack.luts_from_tables(huff_tables))

    print(f"devices: {ndev}; image {h}x{w}, batch {imgs.shape[0]}, 4:2:0")
    print(f"{'mesh':>12} {'flops/shard':>14} {'bytes/shard':>14} "
          f"{'rel flops':>10} {'wall ms':>9}")
    base_flops = None
    sps = [s for s in (1, 2, 4, 8) if s <= ndev and h // 16 % s == 0]
    for sp in sps:
        mesh = make_mesh(sp, batch_axis=1)
        mcu_cols = w // mode.mcu_width
        fn = shard._build_sharded_packed_fn(mesh, mode, mcu_cols)
        spec = NamedSharding(mesh, P("batch", "mcu"))
        dev_imgs = jax.device_put(jnp.asarray(imgs), spec)
        args = (dev_imgs, jnp.asarray(qy), jnp.asarray(qc), *luts)
        lowered = fn.lower(*args)
        compiled = lowered.compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        flops = float(cost.get("flops", float("nan")))
        bytes_ = float(cost.get("bytes accessed", float("nan")))
        # wall clock (virtual mesh: indicative only)
        out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(3):
            jax.block_until_ready(fn(*args))
        dt = (time.time() - t0) / 3 * 1e3
        if base_flops is None:
            base_flops = flops
        print(f"{'1x' + str(sp):>12} {flops:14.3e} {bytes_:14.3e} "
              f"{flops / base_flops:10.3f} {dt:9.1f}")
    print("\nrel flops ~ 1/N confirms weak-scaling of per-shard work; on a"
          "\nmulti-GPU host the same programs run one shard per GPU.")

    # ----- streaming gigapixel mosaic (BASELINE config 5 at contract scale) --
    if os.environ.get("JPEG_TPU_SCALING_GIGA", "1") != "0":
        import resource

        from jpeg_tpu.parallel.mosaic import encode_mosaic_stream

        gh, gw = 32768, 16384  # 0.537 GPix ~ 16x 4K tile area, raw ~1.6 GB

        def source(r0, r1):
            yy = np.arange(r0, r1, dtype=np.uint32)[:, None]
            xx = np.arange(gw, dtype=np.uint32)[None, :]
            z = np.zeros((r1 - r0, gw), np.uint32)
            return np.stack([(xx * 255 // gw + z).astype(np.uint8),
                             (yy * 255 // gh + z).astype(np.uint8),
                             ((xx + yy) * 127 // (gh + gw)).astype(np.uint8)],
                            -1)

        t0 = time.time()
        n = len(encode_mosaic_stream(source, gh, gw, quality=75))
        dt = time.time() - t0
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"\nstreaming mosaic {gh}x{gw} ({gh*gw/1e6:.0f} MPix): "
              f"{dt:.1f}s = {gh*gw/1e6/dt:.1f} MPix/s, {n} bytes out, "
              f"peak RSS {rss:.2f} GB (raw image would be "
              f"{gh*gw*3/1e9:.2f} GB)")


if __name__ == "__main__":
    main()
