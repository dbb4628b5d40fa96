"""Process launcher. reference: paddle_tpu/distributed/launch/__init__.py
(after python/paddle/distributed/launch/main.py:23).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        --master host:port [--backend nccl|gloo] [--log_dir DIR] \\
        script.py [script args]

starts N worker processes of `script.py`, each with PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_LOCAL_RANK, PADDLE_LOCAL_SIZE, PADDLE_MASTER
and PADDLE_DISTRI_BACKEND set, so that the script's `init_parallel_env`
joins them into one process group: NCCL, one rank per card, unless
--backend gloo asks for gloo (two ranks sharing a card). Each
worker's output goes to <log_dir>/worker.<rank>.log when --log_dir is
given. When a worker fails the others are stopped, and the pod restarts
up to --max_restart times. With one worker the script runs in this
process. `spawn` calls its function directly, as the reference's does.
"""

from __future__ import annotations

import argparse
import os
import runpy
import subprocess
import sys
import time

__all__ = ["launch", "spawn", "main"]


def _parse(argv):
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.launch",
                                add_help=True)
    p.add_argument("--master", default=os.environ.get("PADDLE_MASTER"),
                   help="host:port of the rendezvous")
    p.add_argument("--nnodes", default="1",
                   help="node count, or elastic range lo:hi")
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("PADDLE_TRAINER_ID", "0")))
    p.add_argument("--nproc_per_node", "--devices", dest="nproc_per_node",
                   default=None, help="local worker processes")
    p.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                   help="the process group's backend: nccl (the default) "
                        "takes one rank per card; gloo lets ranks share a "
                        "card")
    p.add_argument("--max_restart", type=int, default=3)
    p.add_argument("--elastic_level", type=int, default=-1)
    p.add_argument("--job_id", default="default")
    p.add_argument("--log_dir", default=None)
    p.add_argument("script", help="training script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    # reference-launcher flags this one does not implement (--log_level,
    # --gpus, --ips, --run_mode, ...) are dropped with their values before
    # parsing, so a value is not taken for the script
    known = {a for action in p._actions for a in action.option_strings}
    filtered, ignored = [], []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--") and a.split("=")[0] not in known:
            ignored.append(a)
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            # the next token is this flag's value unless it looks like the
            # script (a valueless flag right before the script)
            if "=" not in a and nxt is not None and not nxt.startswith("-") \
                    and not nxt.endswith((".py", ".sh")):
                ignored.append(nxt)
                i += 1
        elif a.startswith("-"):
            filtered.append(a)  # a known flag (each takes one value)
            if "=" not in a and i + 1 < len(argv):
                filtered.append(argv[i + 1])
                i += 1
        else:
            filtered.extend(argv[i:])  # the script and its args
            break
        i += 1
    if ignored:
        sys.stderr.write(f"launch: ignoring unsupported flags {ignored}\n")
    return p.parse_args(filtered)


def _worker_count(spec):
    """--nproc_per_node N or --devices 0,1,2 (a device-id list)."""
    s = str(spec)
    if "," in s:
        return len([d for d in s.split(",") if d != ""])
    return int(s)


def _nnodes_range(spec):
    if ":" in str(spec):
        lo, hi = str(spec).split(":")
        return int(lo), int(hi)
    return int(spec), int(spec)


def _stop(procs, codes):
    for i, (p, _) in enumerate(procs):
        if codes[i] is None:
            p.terminate()
    for i, (p, _) in enumerate(procs):
        if codes[i] is None:
            try:
                codes[i] = p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                codes[i] = p.wait()


def _run_local_procs(args):
    """One subprocess per local worker; on the first failure the rest are
    stopped (a crashed rank leaves its peers blocked in the rendezvous),
    and the pod restarts up to --max_restart times."""
    if not args.master:
        raise SystemExit("launch: --master host:port is required for more "
                         "than one worker")
    n = _worker_count(args.nproc_per_node)
    restarts = 0
    while True:
        procs = []
        for r in range(n):
            env = dict(os.environ,
                       PADDLE_TRAINER_ID=str(r),
                       PADDLE_TRAINERS_NUM=str(n),
                       PADDLE_LOCAL_RANK=str(r),
                       PADDLE_LOCAL_SIZE=str(n),
                       PADDLE_MASTER=args.master,
                       PADDLE_DISTRI_BACKEND=args.backend)
            out = None
            if args.log_dir:
                os.makedirs(args.log_dir, exist_ok=True)
                out = open(os.path.join(args.log_dir, f"worker.{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, args.script] + list(args.script_args),
                env=env, stdout=out, stderr=subprocess.STDOUT if out else None),
                out))
        codes = [None] * len(procs)
        try:
            while any(c is None for c in codes):
                for i, (p, _) in enumerate(procs):
                    if codes[i] is None:
                        codes[i] = p.poll()
                if any(c not in (None, 0) for c in codes):
                    _stop(procs, codes)
                    break
                time.sleep(0.1)
        finally:
            _stop(procs, codes)
            for _, out in procs:
                if out:
                    out.close()
        if all(c == 0 for c in codes):
            return 0
        restarts += 1
        if restarts > args.max_restart:
            sys.stderr.write(
                f"launch: workers failed (codes {codes}), max_restart "
                f"({args.max_restart}) exhausted\n")
            return 1
        sys.stderr.write(
            f"launch: workers failed (codes {codes}), restart "
            f"{restarts}/{args.max_restart}\n")
        time.sleep(1.0)


def main(argv=None):
    args = _parse(argv if argv is not None else sys.argv[1:])
    if args.nproc_per_node is not None and \
            _worker_count(args.nproc_per_node) > 1:
        sys.exit(_run_local_procs(args))
    # one process on this host: join the pod (multi-node), run the script
    lo, _ = _nnodes_range(args.nnodes)
    if args.master and lo > 1:
        os.environ.setdefault("PADDLE_MASTER", args.master)
        os.environ.setdefault("PADDLE_TRAINERS_NUM", str(lo))
        os.environ.setdefault("PADDLE_TRAINER_ID", str(args.rank))
        os.environ.setdefault("PADDLE_LOCAL_SIZE", "1")
        os.environ.setdefault("PADDLE_DISTRI_BACKEND", args.backend)
    from ..parallel_env import init_parallel_env
    init_parallel_env()
    sys.argv = [args.script] + list(args.script_args)
    runpy.run_path(args.script, run_name="__main__")


def launch():
    main()


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """A direct call, as the reference's spawn is."""
    func(*args)
    return None
