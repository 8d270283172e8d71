#!/usr/bin/env python3
"""Probe of torch.distributed on one NVIDIA GPU: what the mesh layer
(qwen3_tts_tpu_torch/parallel/) can run on a one-card host.

    python3 chip_dist_probe.py

1. a world-size-1 NCCL process group in this process: a 1x1
   ``DeviceMesh`` ("dp", "tp"), all_gather, all_reduce and
   all_gather_object over its groups, and the ms of one all_gather of a
   40-frame chunk's packed outputs at 8 streams ([8, 40 * 17 + 1] int32);
2. two spawned ranks sharing card 0 over gloo (NCCL refuses two ranks on
   one device): whether gloo takes CUDA tensors for all_reduce,
   all_gather and all_gather_object, a 1x2 ``DeviceMesh`` on the card,
   and the ms of one all_reduce over its tp group.

Each step prints its result or FAIL with the exception: the probe
reports what works, it does not choose a path.
"""

import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def _gloo_rank(rank: int, world: int, store: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    res, mesh = {}, None
    steps = ("all_reduce", "all_gather", "all_gather_object", "mesh",
             "mesh_all_reduce_ms")
    for name in steps:
        try:
            if name == "all_reduce":
                x = torch.full((4, 1024), float(rank + 1), device="cuda")
                dist.all_reduce(x)
                res[name] = x[0, 0].item()
            elif name == "all_gather":
                x = torch.full((3, 5), rank, dtype=torch.int32, device="cuda")
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                res[name] = [p[0, 0].item() for p in parts]
            elif name == "all_gather_object":
                out = [None] * world
                dist.all_gather_object(out, {"r": rank})
                res[name] = out
            elif name == "mesh":
                mesh = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                                  mesh_dim_names=("dp", "tp"))
                res[name] = (mesh.get_local_rank("tp"), tuple(mesh.shape))
            else:
                x = torch.ones(2, 8, device="cuda")
                t0 = time.perf_counter()
                for _ in range(50):
                    dist.all_reduce(x, group=mesh.get_group("tp"))
                torch.cuda.synchronize()
                res[name] = (time.perf_counter() - t0) / 50 * 1e3
        except Exception as e:
            res[name] = "FAIL " + repr(e)[:300]
    print("gloo rank", rank, res, flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_dist_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp()
    try:
        from torch.distributed.device_mesh import DeviceMesh
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                                rank=0, world_size=1)
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("dp", "tp"))
        x = torch.ones(4, device="cuda")
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x, group=mesh.get_group("dp"))
        dist.all_reduce(x, group=mesh.get_group("tp"))
        out = [None]
        dist.all_gather_object(out, {"a": 1}, group=mesh.get_group("dp"))
        y = torch.zeros(8, 40 * 17 + 1, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            dist.all_gather([torch.empty_like(y)], y,
                            group=mesh.get_group("dp"))
        torch.cuda.synchronize()
        print("nccl world size 1 ok", parts[0].tolist(), x.tolist(), out,
              f"all_gather {(time.perf_counter() - t0) * 10:.4f} ms",
              flush=True)
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        print("nccl world size 1 FAIL", flush=True)
    torch.multiprocessing.spawn(_gloo_rank, args=(2, f"{tmp}/gloo"),
                                nprocs=2, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
