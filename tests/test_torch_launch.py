"""The port's launcher CLI and spawn, held to the reference's cases
(``tests/test_launch.py``): the trainer env contract, exit codes, worker
logs, elastic restarts; and the contract carried through to a real
2-rank rendezvous (``init_parallel_env`` over gloo).

Every launcher run is a subprocess in a process group of its own, killed
whole past its time limit. The reference's launcher is run on the same
scripts where the cases agree, so both packages are held to one contract.
"""
import os
import signal
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_group(cmd, env, cwd=None, timeout=120):
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait(timeout=10)
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _run_launch(tmp_path, script_body, extra_args=(), nproc=2,
                package="paddle_tpu_torch", env_extra=None):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(script_body))
    env = _env()
    env.update(env_extra or {})
    cmd = [sys.executable, "-m", f"{package}.distributed.launch",
           "--nproc_per_node", str(nproc),
           "--log_dir", str(tmp_path / "log"), *extra_args, str(script)]
    return _run_group(cmd, env, cwd=str(tmp_path))


ENV_CONTRACT = """
    import os
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    n = int(os.environ["PADDLE_TRAINERS_NUM"])
    eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
    cur = os.environ["PADDLE_CURRENT_ENDPOINT"]
    assert n == 2 and len(eps) == 2 and eps[rank] == cur, (eps, cur)
    assert os.environ["MASTER_ADDR"]
    assert eps[0].rsplit(":", 1)[1] == os.environ["MASTER_PORT"]
    with open(f"ok.{rank}", "w") as f:
        f.write(cur + " " + os.environ.get("FLAGS_selected_gpus", "-"))
"""


@pytest.mark.parametrize("package", ["paddle_tpu_torch", "paddle_tpu"])
def test_env_contract_and_success(tmp_path, package):
    r = _run_launch(tmp_path, ENV_CONTRACT, package=package)
    assert r.returncode == 0, r.stderr
    a, b = ((tmp_path / f"ok.{i}").read_text().split() for i in (0, 1))
    assert a[0] != b[0]  # distinct endpoints per rank
    if package == "paddle_tpu_torch":  # one card a process
        assert (a[1], b[1]) == ("0", "1")


def test_failure_propagates_exit_code(tmp_path):
    r = _run_launch(tmp_path, """
        import os, sys
        sys.exit(7 if os.environ["PADDLE_TRAINER_ID"] == "1" else 0)
    """)
    assert r.returncode == 7


def test_elastic_restarts_then_gives_up(tmp_path):
    r = _run_launch(tmp_path, """
        import sys
        sys.exit(3)
    """, extra_args=("--elastic_level", "1", "--max_restart", "2"), nproc=1)
    assert r.returncode == 3
    assert r.stderr.count("restart") == 2


def test_exit_101_asks_for_a_relaunch_at_any_level(tmp_path):
    r = _run_launch(tmp_path, """
        import os, sys
        mark = "relaunched"
        if not os.path.exists(mark):
            open(mark, "w").close()
            sys.exit(101)
    """, nproc=1)
    assert r.returncode == 0, r.stderr
    assert r.stderr.count("restart") == 1


def test_worker_logs_written(tmp_path):
    r = _run_launch(tmp_path, """
        import os
        print("hello from", os.environ["PADDLE_TRAINER_ID"])
    """)
    assert r.returncode == 0
    log = (tmp_path / "log" / "workerlog.1").read_text()
    assert "hello from 1" in log


def test_launched_ranks_rendezvous_and_reduce(tmp_path):
    """The contract reaches init_parallel_env: two launched ranks meet on
    rank 0's store (the first endpoint) and all-reduce over gloo, and the
    checkpoint coordinator built from the same env joins that store."""
    r = _run_launch(tmp_path, """
        import torch
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch.distributed.checkpoint import \\
            coordinator_from_env
        dist.init_parallel_env()
        r = dist.get_rank()
        x = torch.tensor([float(r + 1)])
        dist.all_reduce(x)
        co = coordinator_from_env(timeout=30)
        got = co.negotiate_resume(r)  # the fleet agrees on the minimum
        with open(f"sum.{r}", "w") as f:
            f.write(f"{dist.get_backend()} {float(x)} {got}")
        dist.destroy_process_group()
    """, env_extra={"PADDLE_DISTRI_BACKEND": "gloo"})
    assert r.returncode == 0, r.stderr
    for i in (0, 1):
        assert (tmp_path / f"sum.{i}").read_text() == "gloo 3.0 0"


SPAWN = """
    import os, sys

    def work(base):
        import os
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        with open(f"{base}/spawn.{rank}", "w") as f:
            f.write(os.environ["PADDLE_CURRENT_ENDPOINT"] + " "
                    + os.environ["MASTER_PORT"])

    if __name__ == "__main__":
        sys.path.insert(0, sys.argv[2])
        from paddle_tpu_torch.distributed import spawn
        spawn(work, args=(sys.argv[1],), nprocs=int(sys.argv[3]))
"""


@pytest.mark.parametrize("nprocs", [1, 2])
def test_spawn_runs_workers(tmp_path, nprocs):
    script = tmp_path / "sp.py"
    script.write_text(textwrap.dedent(SPAWN))
    r = _run_group([sys.executable, str(script), str(tmp_path), REPO,
                    str(nprocs)], _env(), timeout=120)
    assert r.returncode == 0, r.stderr
    eps = [(tmp_path / f"spawn.{i}").read_text().split()
           for i in range(nprocs)]
    assert len({e[0] for e in eps}) == nprocs
    assert all(e[0].endswith(":" + eps[0][1]) for e in eps[:1])


def test_spawn_surfaces_a_failing_rank(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text(textwrap.dedent("""
        import os, sys

        def work():
            import os
            if os.environ["PADDLE_TRAINER_ID"] == "1":
                raise ValueError("rank one fails")

        if __name__ == "__main__":
            sys.path.insert(0, sys.argv[1])
            from paddle_tpu_torch.distributed import spawn
            spawn(work, nprocs=2)
    """))
    r = _run_group([sys.executable, str(script), REPO], _env(), timeout=120)
    assert r.returncode != 0
    assert "rank 1: rank one fails" in r.stderr
