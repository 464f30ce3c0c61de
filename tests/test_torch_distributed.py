"""The port's multi-process bring-up, as ``tests/test_distributed.py``
holds the reference's: two processes on the CPU, each one rank of a
world joined by ``parallel.distributed_initialize`` (gloo), and a sum
across the process boundary, the reference's ``psum`` of 12.0.  Each
worker imports ``torch`` and the port only.
"""

import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

WORKER = textwrap.dedent("""
    import sys
    pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, %(repo)r)
    import torch
    import torch.distributed as dist

    from siddhi_tpu_torch.parallel import distributed_initialize

    distributed_initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=n, process_id=pid, device="cpu")
    assert dist.get_world_size() == n and dist.get_rank() == pid
    assert dist.get_backend() == "gloo"
    # one shard a process; the sum crosses the process boundary
    local = torch.full((1, 4), float(pid + 1))
    total = local.sum()
    dist.all_reduce(total)
    expect = 4.0 * sum(range(1, n + 1))
    assert float(total) == expect, (float(total), expect)
    dist.destroy_process_group()
    assert "jax" not in sys.modules and "siddhi_tpu" not in sys.modules
    print(f"proc {pid} OK psum={float(total)}")
""")


def test_two_process_gloo_psum(tmp_path):
    with socket.socket() as s:  # a free port for rank 0's store
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "worker.py"
    script.write_text(WORKER % {
        "repo": str(Path(__file__).resolve().parent.parent)})
    env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK psum=12.0" in out, out
