"""Multi-host (DCN) runtime path: a LIVE 2-process jax.distributed
CPU exercise plus unit tests of the init veneer's failure semantics
(parallel/mesh.py:multihost_initialize).

The reference is single-process (SURVEY.md section 2.6); the multi-host
leg exists only in this framework.  The live test spawns two real
processes, each with 4 virtual CPU devices, forms the global dp=2 x
sp=4 mesh, and runs a cross-process psum — the same collective layout
`make_mesh({"dp": H, "sp": -1})` would put over DCN x ICI on a pod.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).parent / "_multihost_worker.py"
REPO = Path(__file__).parent.parent


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_psum():
    port = _free_port()
    env = dict(os.environ)
    # keep the caller's PYTHONPATH and prepend the repo so the workers
    # import the package
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(port), str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=str(REPO),
            env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid} OK psum=28.0" in out, out
        # the full 2-D-sharded align ran its per-iteration collectives
        # across the process boundary and matched the single-device
        # reference per lane
        assert f"worker {pid} OK train2d" in out, out


def test_multihost_initialize_swallows_only_already_initialized(
    monkeypatch,
):
    import jax

    from cvo_rgbd_tpu.parallel import multihost_initialize

    calls = []

    def fake_ok(**kw):
        calls.append(kw)
        raise RuntimeError("backend is already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", fake_ok)
    multihost_initialize(num_processes=2)  # benign: must not raise
    assert calls

    def fake_fail(**kw):
        raise RuntimeError("failed to connect to coordinator")

    monkeypatch.setattr(jax.distributed, "initialize", fake_fail)
    with pytest.raises(RuntimeError, match="coordinator"):
        multihost_initialize(num_processes=2)
