"""``python -m paddle_tpu_torch.distributed.launch`` — the job launcher
(counterpart of ``paddle_tpu/distributed/launch/main.py``).

paddle's launcher (``python/paddle/distributed/launch/main.py``) builds a
job/pod model, exports the trainer env contract (``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ENDPOINTS`` /
``PADDLE_CURRENT_ENDPOINT``, ``MASTER_ADDR``/``MASTER_PORT``), starts and
supervises the local workers, propagates the first failing exit code and
restarts per elastic level. The port starts one process a rank with one
card a process (``FLAGS_selected_gpus`` = its local rank); the first
endpoint is where rank 0 hosts the rendezvous store of
``init_parallel_env``. With ``PADDLE_DISTRI_BACKEND=gloo`` several
processes may share one card.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 train.py
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

#: a worker's explicit request to relaunch the pod (paddle's
#: ``elastic/manager.py:37``), honored at any elastic level
ELASTIC_EXIT_CODE = 101


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a distributed training job")
    p.add_argument("--master", default=None,
                   help="ip:port of rank-0 host (default: localhost:PORT)")
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", "1")))
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", "0")),
                   help="this node's rank in [0, nnodes)")
    p.add_argument("--nproc_per_node", type=int,
                   default=int(os.environ.get("PADDLE_NPROC_PER_NODE", "1")))
    p.add_argument("--log_dir", default="log")
    p.add_argument("--job_id", default="default")
    p.add_argument("--devices", "--gpus", default=None,
                   help="visible cards, split over the local workers "
                        "(sets CUDA_VISIBLE_DEVICES)")
    p.add_argument("--elastic_level", type=int, default=int(os.environ.get(
        "PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", "0")))
    p.add_argument("--max_restart", type=int, default=3)
    p.add_argument("--host", default=None, help="this node's address")
    p.add_argument("--module", action="store_true",
                   help="treat training_script as a module (python -m)")
    p.add_argument("training_script",
                   help="training script path (or module name with --module)")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


class Pod:
    """The local processes of one node (paddle's job/pod model)."""

    def __init__(self, args):
        from ..env import find_free_port
        self.args = args
        host = args.host or "127.0.0.1"
        master = args.master or f"127.0.0.1:{find_free_port()}"
        if ":" not in master:
            master = f"{master}:{find_free_port()}"
        self.master = master
        nproc = args.nproc_per_node
        world = args.nnodes * nproc
        mhost, mport = master.rsplit(":", 1)
        # one endpoint a worker, rank-major over nodes, ports derived from
        # the master's so every node derives the same list; only eps[0]
        # (rank 0's rendezvous store) must be reachable
        base = int(mport)
        self.endpoints = []
        for node in range(args.nnodes):
            nh = host if node == args.rank else mhost
            for i in range(nproc):
                self.endpoints.append(f"{nh}:{base + node * nproc + i}")
        self.world_size = world
        self.local_ranks = list(range(args.rank * nproc,
                                      (args.rank + 1) * nproc))
        self.procs: List[subprocess.Popen] = []

    def env_for(self, global_rank: int, local_rank: int) -> dict:
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(global_rank),
            "PADDLE_TRAINERS_NUM": str(self.world_size),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(self.endpoints),
            "PADDLE_CURRENT_ENDPOINT": self.endpoints[global_rank],
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_JOB_ID": self.args.job_id,
            "MASTER_ADDR": self.master.rsplit(":", 1)[0],
            "MASTER_PORT": self.master.rsplit(":", 1)[1],
            "FLAGS_selected_gpus": str(local_rank),
        })
        if self.args.devices is not None:
            devs = self.args.devices.split(",")
            nproc = self.args.nproc_per_node
            if len(devs) >= nproc and len(devs) % nproc == 0:
                per = len(devs) // nproc  # partition across local workers
                mine = ",".join(devs[local_rank * per:(local_rank + 1) * per])
                env["FLAGS_selected_gpus"] = "0"
            else:
                mine = self.args.devices
            env["CUDA_VISIBLE_DEVICES"] = mine
        return env

    def deploy(self):
        os.makedirs(self.args.log_dir, exist_ok=True)
        self.procs = []
        cmd = [sys.executable, "-u"]
        if self.args.module:
            cmd += ["-m", self.args.training_script]
        else:
            cmd += [self.args.training_script]
        script_args = self.args.training_script_args
        for local_rank, global_rank in enumerate(self.local_ranks):
            log = open(os.path.join(self.args.log_dir,
                                    f"workerlog.{global_rank}"), "ab")
            proc = subprocess.Popen(
                cmd + script_args, env=self.env_for(global_rank, local_rank),
                stdout=log if local_rank != 0 else None,
                stderr=subprocess.STDOUT if local_rank != 0 else None)
            proc._log_file = log  # keep for close
            self.procs.append(proc)

    def poll(self) -> Optional[int]:
        """None while all run; else the first non-zero code, or 0 when
        every worker succeeded."""
        codes = [p.poll() for p in self.procs]
        for c in codes:
            if c is not None and c != 0:
                return c
        if all(c == 0 for c in codes):
            return 0
        return None

    def report_failures(self, tail_bytes: int = 4000) -> None:
        """For each worker that exited non-zero, its exit code and the end
        of its log on the launcher's stderr (rank 0 writes to the
        launcher's own streams), so the failing rank's error reaches
        whoever reads the launcher's output."""
        for p, rank in zip(self.procs, self.local_ranks):
            code = p.poll()
            if code in (None, 0):
                continue
            msg = f"[launch] rank {rank} exited {code}"
            path = os.path.join(self.args.log_dir, f"workerlog.{rank}")
            if os.path.exists(path):
                with open(path, "rb") as log:
                    log.seek(0, os.SEEK_END)
                    log.seek(max(0, log.tell() - tail_bytes))
                    tail = log.read().decode(errors="replace")
                if tail:
                    msg += f"; the end of {path}:\n{tail}"
            print(msg, file=sys.stderr, flush=True)

    def stop(self, sig=signal.SIGTERM):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass
        deadline = time.time() + 10
        for p in self.procs:
            try:
                p.wait(max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for p in self.procs:
            f = getattr(p, "_log_file", None)
            if f is not None:
                f.close()


def launch(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    restarts = 0
    while True:
        pod = Pod(args)
        pod.deploy()
        code = None
        try:
            while code is None:
                time.sleep(0.2)
                code = pod.poll()
        except KeyboardInterrupt:
            pod.stop(signal.SIGINT)
            return 130
        if code != 0:
            pod.report_failures()
        pod.stop()
        if code == 0:
            return 0
        if (code == ELASTIC_EXIT_CODE or args.elastic_level > 0) \
                and restarts < args.max_restart:
            restarts += 1
            print(f"[launch] worker failed (exit {code}); restart "
                  f"{restarts}/{args.max_restart}", file=sys.stderr)
            continue
        return code


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()
