#!/usr/bin/env python3
"""Which torch.distributed operations work on a gloo world of two ranks
that share one CUDA device (NCCL refuses two ranks on one GPU, so this
is how the parallel plane's two-rank paths run on a single card).

Each case runs in a fresh pair of ranks, since a crash ends the process:

* ``cpu_ar``: ``all_reduce`` of a CPU tensor;
* ``cuda_ar``: ``all_reduce`` of a CUDA tensor;
* ``cuda_ar_staged``: the (8192, 4, 29) float32 quadrature block of a
  bins-sharded headline sweep, copied to pinned host memory,
  all-reduced and copied back, 20 times (the mean time printed);
* ``mesh_cuda``: a ``DeviceMesh("cuda", ...)`` in the gloo world (the
  backend of its subgroups) and an ``all_reduce`` on a subgroup;
* ``cuda_allgather``: ``all_gather_into_tensor`` of CUDA tensors;
* ``dtensor_cuda``: ``DTensor.full_tensor()`` of a CUDA DTensor.

Prints each case's exit codes and the last lines of both ranks' output
(with Python's fault handler on, a segmentation fault shows its stack).

    python3 tools/torch_dist_probe.py      # on a machine with a GPU
"""

import datetime
import faulthandler
import os
import socket
import subprocess
import sys
import time

import torch

faulthandler.enable()
CASES = ("cpu_ar", "cuda_ar", "cuda_ar_staged", "mesh_cuda",
         "cuda_allgather", "dtensor_cuda")


def step(msg):
    print(f"[r{os.environ.get('R')}] {msg}", flush=True)


def worker(case, rank, world, port):
    import torch.distributed as dist
    torch.cuda.set_device(0)
    step("init")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    step("inited")
    if case == "cpu_ar":
        x = torch.full((4,), float(rank + 1))
        dist.all_reduce(x)
        step(f"ok {x.tolist()}")
    elif case == "cuda_ar":
        x = torch.full((4,), float(rank + 1), device="cuda")
        torch.cuda.synchronize()
        step("tensor made")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        step(f"ok {x.tolist()}")
    elif case == "cuda_ar_staged":
        x = torch.full((8192, 4, 29), float(rank + 1), device="cuda")
        h = torch.empty(x.shape, pin_memory=True)
        t = time.perf_counter()
        for _ in range(20):
            h.copy_(x)
            dist.all_reduce(h)
            x.copy_(h, non_blocking=True)
        torch.cuda.synchronize()
        step(f"ok {x[0, 0, 0].item()} "
             f"{(time.perf_counter() - t) / 20 * 1e3:.3f} ms")
    elif case == "mesh_cuda":
        from torch.distributed.device_mesh import DeviceMesh
        m = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                       mesh_dim_names=("columns", "bins"))
        step(f"ok backend {dist.get_backend(m.get_group('bins'))}")
        x = torch.full((4,), float(rank + 1))
        dist.all_reduce(x, group=m.get_group("bins"))
        step(f"cpu ar on sub ok {x.tolist()}")
    elif case == "dtensor_cuda":
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        m = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                       mesh_dim_names=("columns", "bins"))
        y = torch.ones(2, 3, device="cuda") * (rank + 1)
        d = DTensor.from_local(y, m, [Replicate(), Shard(1)],
                               run_check=False)
        step("from_local ok")
        step(f"ok {d.full_tensor().tolist()}")
    elif case == "cuda_allgather":
        x = torch.full((2,), float(rank + 1), device="cuda")
        out = torch.empty(4, device="cuda")
        dist.all_gather_into_tensor(out, x)
        torch.cuda.synchronize()
        step(f"ok {out.tolist()}")
    dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main():
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for case in CASES:
        port = free_port()
        t = time.perf_counter()
        ps = [subprocess.Popen(
            [sys.executable, __file__, "w", case, str(r), str(port)],
            env=dict(os.environ, R=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        for p in ps:
            try:
                outs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\nTIMEOUT")
        print(f"=== {case}: rc {[p.returncode for p in ps]} "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        for o in outs:
            print("\n".join(o.splitlines()[-25:]), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["w"]:
        worker(sys.argv[2], int(sys.argv[3]), 2, int(sys.argv[4]))
    else:
        if not torch.cuda.is_available():
            sys.exit("torch_dist_probe: needs a CUDA device")
        main()
