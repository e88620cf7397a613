"""Worker for tests/test_multihost.py — one of two cooperating
processes forming a 2-process (DCN-analog) CPU mesh via
jax.distributed.  Each process contributes 4 virtual devices; the
global mesh is dp=2 (across processes — the DCN axis) x sp=4 (within
a process — the ICI axis), and a shard_map psum must see all 8
devices.

Usage: python tests/_multihost_worker.py <port> <process_id>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    port, pid = sys.argv[1], int(sys.argv[2])

    from jax.sharding import NamedSharding, PartitionSpec as P

    import numpy as np

    from cvo_rgbd_tpu.parallel import make_mesh, multihost_initialize

    multihost_initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()
    assert len(jax.local_devices()) == 4

    # repeated init must be the benign no-op path
    multihost_initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )

    mesh = make_mesh({"dp": 2, "sp": 4})

    local = (np.arange(4, dtype=np.float32) + 4 * pid)  # 0..7 globally
    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(("dp", "sp"))), local, (8,)
    )
    f = jax.shard_map(
        lambda x: jax.lax.psum(x, ("dp", "sp")),
        mesh=mesh,
        in_specs=P(("dp", "sp")),
        out_specs=P(),
        check_vma=False,
    )
    out = jax.jit(f)(garr)
    val = float(np.asarray(out.addressable_data(0))[0])
    assert val == 28.0, val  # sum(0..7): the psum crossed both processes
    print(f"worker {pid} OK psum={val}", flush=True)

    # ---- a REAL collective align across the process boundary
    #: train_step_2d with dp across the two
    # processes (the DCN-analog axis) x sp within each process; every
    # per-iteration psum of the align loop crosses DCN.  Each process
    # computes its own lane's single-device reference and checks its
    # shard of the global result.
    import functools

    from cvo_rgbd_tpu import CvoParams, pad_cloud, se3
    from cvo_rgbd_tpu.core.cloud import PointCloud
    from cvo_rgbd_tpu.core.registration import align
    from cvo_rgbd_tpu.parallel import train_step_2d

    p = CvoParams(max_iter=12)
    cap = 256

    def lane(k):
        r = np.random.default_rng(100 + k)
        n = 90
        base = r.standard_normal((n + 30, 3)).astype(np.float32) * 0.4
        feat = (r.random((n + 30, 5))
                * np.array([255, 255, 255, 60, 60])).astype(np.float32)
        R = np.asarray(
            se3.exp_so3(np.array([0.01, -0.012, 0.008], np.float32))
        )
        t = np.array([0.02, -0.01, 0.015], np.float32)
        yp = (base[20:20 + n] @ R.T + t).astype(np.float32)
        return (pad_cloud(base[:n], feat[:n], capacity=cap),
                pad_cloud(yp, feat[20:20 + n], capacity=cap))

    loc_f, loc_m = lane(pid)

    def gfield(local, spec, gshape):
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), np.asarray(local)[None], gshape
        )

    def gcloud(c):
        return PointCloud(
            gfield(c.positions, P("dp", "sp", None), (2, cap, 3)),
            gfield(c.features, P("dp", "sp", None), (2, cap, 5)),
            gfield(c.mask, P("dp", "sp"), (2, cap)),
        )

    res = jax.jit(functools.partial(train_step_2d, p, mesh))(
        gcloud(loc_f), gcloud(loc_m)
    )
    tf_local = np.asarray(res.tf.addressable_data(0)).reshape(4, 4)
    ref = align(p, loc_f, loc_m)
    dtf = float(np.abs(tf_local - np.asarray(ref.tf)).max())
    assert dtf < 2e-5, dtf
    assert np.isfinite(tf_local).all()
    print(f"worker {pid} OK train2d dtf={dtf:.2e}", flush=True)


if __name__ == "__main__":
    main()
