"""Device mesh construction for the JPEG engine.

Two mesh axes (SURVEY.md §2 parallelism table):
  * ``batch`` — data parallelism over independent images (BASELINE config 4);
  * ``mcu``   — sequence parallelism over horizontal MCU stripes of one image,
                the JPEG analog of context parallelism: restart segments / DC
                predictor chains are the sequence being sharded (config 5).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, batch_axis: int | None = None) -> Mesh:
    """Build a (batch, mcu) mesh over the first n available devices.

    batch_axis: size of the data-parallel axis; defaults to the largest
    power-of-two divisor <= sqrt(n) so both axes get parallelism.
    """
    devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if batch_axis is None:
        batch_axis = 1
        while (
            batch_axis * 2 <= n // (batch_axis * 2)
            and n % (batch_axis * 2) == 0
        ):
            batch_axis *= 2
    if n % batch_axis:
        raise ValueError(f"{n} devices not divisible by batch axis {batch_axis}")
    arr = np.array(devices[:n]).reshape(batch_axis, n // batch_axis)
    return Mesh(arr, axis_names=("batch", "mcu"))


def to_host(x) -> np.ndarray:
    """Gather a (possibly multi-process) global array to host memory.

    np.asarray works only on fully-addressable arrays; across processes the
    shards live on other hosts, so every process all-gathers the global value
    (jax.experimental.multihost_utils) — the host-assembly steps of
    encode_batch/decode_batch then run identically on every process.
    """
    if isinstance(x, np.ndarray) or getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def host_to_global(x, spec):
    """device_put that also works when `spec` spans multiple processes.

    A committed single-device array cannot be resharded across processes, so
    under multi-process the value is first materialized on the host (every
    process holds the same full value by construction) and then sharded.
    """
    if jax.process_count() > 1 and not isinstance(x, np.ndarray):
        x = np.asarray(x)
    return jax.device_put(x, spec)


def make_multihost_mesh(batch_axis: int | None = None,
                        coordinator_address: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None) -> Mesh:
    """Multi-host (batch, mcu) mesh over every process's devices.

    Call once per host process. Device order from jax.devices() after
    jax.distributed.initialize() groups each host's devices, so neighbouring
    ``mcu`` stripes stay within a host (NVLink, all to all among the GPUs
    of one host) and cross the network only at host boundaries — the stripe
    pipeline (parallel.shard) and the single-JFIF stitch (parallel.mosaic)
    run unchanged; only this constructor differs from single-host use.
    coordinator_address is required on GPU hosts (e.g. "localhost:<port>"
    for several processes on one host), with num_processes and process_id.

    Exercised by tests/test_multiprocess.py (CPU processes) and the
    virtual-device path in tests/test_parallel.py.
    """
    import jax

    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return make_mesh(batch_axis=batch_axis)
