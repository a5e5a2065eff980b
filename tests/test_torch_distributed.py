"""Two real processes through the port's ``parallel/distributed.py``, the
counterpart of ``tests/test_distributed.py``: ``init_multihost`` with an
explicit coordinator (a ``file://`` rendezvous under ``tmp_path``, so no
port is taken), ``shard_work`` over the group, and collectives across the
processes: a sum, and the helpers of ``parallel/mesh.py`` (``all_reduce``,
``all_gather`` on each mesh axis, ``gather_results``) over a (1 x 2) and
a (2 x 1) mesh.
"""
import json
import os
import subprocess
import sys
import textwrap

from dropoutdecoding_tpu_torch.parallel.distributed import init_multihost, shard_work

_WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from dropoutdecoding_tpu_torch.parallel.distributed import init_multihost, shard_work
    from dropoutdecoding_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    url, pid = sys.argv[1], int(sys.argv[2])
    ok = init_multihost(coordinator_address=url, num_processes=2, process_id=pid)
    assert ok, "init_multihost returned False with an explicit coordinator"
    out = {
        "rank": dist.get_rank(),
        "world": dist.get_world_size(),
        "backend": dist.get_backend(),
        "share": shard_work(list(range(10))),
    }
    x = torch.tensor([float(pid + 1)])  # rank 0: 1, rank 1: 2
    dist.all_reduce(x)
    out["sum"] = x.item()
    tp = pm.make_mesh(n_data=1, n_model=2)
    dp = pm.make_mesh(n_data=2)
    out["tp"] = [tp.data_rank, tp.model_rank]
    out["dp"] = [dp.data_rank, dp.model_rank]
    y = torch.full((2,), 3.0 * (pid + 1))
    out["max"] = pm.all_reduce(y, tp, op="max").tolist()
    block = torch.arange(3.0) + 10 * pid
    out["gather_model"] = pm.all_gather(block, tp).tolist()
    out["gather_data"] = pm.all_gather(block[None], dp, "data", dim=0).tolist()
    # one rank on the axis: the input back, no collective issued or counted
    out["one_rank_axis"] = [pm.all_reduce(torch.full((2,), 5.0 + pid), tp, "data").tolist(),
                            pm.all_gather(block, dp).tolist()]
    out["calls"] = [pm.all_reduce.calls, pm.all_gather.calls]
    # DP results gathered with no device named: the host, under gloo
    from dropoutdecoding_tpu_torch.engine.generate import GenerationResult
    got = pm.gather_results(GenerationResult(tokens=np.array([[pid, 7 + pid]]),
                                             num_tokens=np.array([2])), dp)
    out["results"] = [got.tokens.tolist(), got.num_tokens.tolist()]
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
    """
)


def test_two_process_init_shard_and_collectives(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    url = f"file://{tmp_path / 'rendezvous'}"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("MASTER_ADDR", None)
    procs = [
        subprocess.Popen([sys.executable, str(worker), url, str(pid)], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, env=env, cwd=repo_root)
        for pid in (0, 1)
    ]
    results = {}
    for pid, p in zip((0, 1), procs):
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, (pid, err.decode()[-2000:])
        line = [l for l in out.decode().splitlines() if l.startswith("RESULT ")]
        assert line, out.decode()[-1000:]
        results[pid] = json.loads(line[-1][len("RESULT "):])

    for pid in (0, 1):
        r = results[pid]
        assert r["world"] == 2 and r["rank"] == pid
        assert r["backend"] == "gloo"  # no CUDA here
        assert r["sum"] == 3.0  # 1 + 2 summed across the processes
        assert r["tp"] == [0, pid] and r["dp"] == [pid, 0]
        assert r["max"] == [6.0, 6.0]
        assert r["gather_model"] == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]
        assert r["gather_data"] == [[0.0, 1.0, 2.0], [10.0, 11.0, 12.0]]
        assert r["one_rank_axis"] == [[5.0 + pid] * 2, [10.0 * pid + k for k in range(3)]]
        assert r["calls"] == [1, 2]
        assert r["results"] == [[[0, 7], [1, 8]], [2, 2]]

    s0, s1 = set(results[0]["share"]), set(results[1]["share"])
    assert s0 == set(range(0, 10, 2)) and s1 == set(range(1, 10, 2))


def test_init_multihost_noop_without_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert init_multihost() is False


def test_shard_work_explicit_topology():
    items = list("abcdefg")
    shares = [shard_work(items, process_index=i, process_count=3) for i in range(3)]
    assert sorted(sum(shares, [])) == sorted(items)
    assert all(set(a).isdisjoint(b) for i, a in enumerate(shares) for b in shares[i + 1:])
