"""Which collectives four ranks sharing one card can run: a 4-rank world
of gloo and then of NCCL (every rank on cuda:0, a (2, 2) DeviceMesh),
each rank trying all_gather, all_gather_into_tensor, all_reduce,
batch_isend_irecv, broadcast and a DTensor full_tensor on CUDA tensors.
Prints each rank's outcome; a rank that aborts (gloo on a CUDA tensor:
``writev ... Bad address``) leaves no record, and a rank still waiting
is killed at the 120 s join.

    python3 tools/dist_backend_probe.py

Needs one CUDA card; about 40 s on an H100 (every gloo rank aborted on
its first collective, every NCCL collective refused as invalid usage),
up to 5 minutes when ranks hang."""
import os, sys, json, subprocess, time
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def worker(rank, world, port, backend, out):
    res = {}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method="tcp://localhost:%d" % port, world_size=world, rank=rank)
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(2, world // 2), mesh_dim_names=("dp", "sp"))
        res["mesh"] = str(mesh)
        t = torch.full((3,), float(rank), device="cuda")
        for name, fn in [
            ("all_gather", lambda: (lambda l: (dist.all_gather(l, t), [x.tolist() for x in l])[1])([torch.empty_like(t) for _ in range(world)])),
            ("all_gather_into_tensor", lambda: (lambda o: (dist.all_gather_into_tensor(o, t), o.tolist())[1])(torch.empty(world * 3, device="cuda"))),
            ("all_reduce", lambda: (lambda x: (dist.all_reduce(x), x.tolist())[1])(t.clone())),
            ("isend_irecv", lambda: (lambda b: ([r.wait() for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, (rank + 1) % world), dist.P2POp(dist.irecv, b, (rank - 1) % world)])], b.tolist())[1])(torch.empty_like(t))),
            ("broadcast", lambda: (lambda x: (dist.broadcast(x, 0), x.tolist())[1])(t.clone())),
        ]:
            try:
                res[name] = fn()
            except Exception as e:
                res[name] = "ERR %s: %s" % (type(e).__name__, str(e)[:200])
        try:
            from torch.distributed.tensor import DTensor, Shard, Replicate
            d = DTensor.from_local(t, mesh, [Shard(0), Replicate()], run_check=False)
            res["dtensor"] = str(d.shape)
            try:
                res["full_tensor"] = d.full_tensor().tolist()
            except Exception as e:
                res["full_tensor"] = "ERR %s: %s" % (type(e).__name__, str(e)[:200])
        except Exception as e:
            res["dtensor"] = "ERR %s: %s" % (type(e).__name__, str(e)[:200])
        dist.destroy_process_group()
    except Exception as e:
        res["init"] = "ERR %s: %s" % (type(e).__name__, str(e)[:300])
    with open(out % rank, "w") as fh:
        json.dump(res, fh)

if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count(), torch.cuda.get_device_name(0))
    print("nccl", dist.is_nccl_available(), "gloo", dist.is_gloo_available())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout)
    try:
        import triton; print("triton", triton.__version__)
    except Exception as e:
        print("triton", e)
    for i, backend in enumerate(["gloo", "nccl"]):
        t0 = time.time()
        folder = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "build", "probe")
        os.makedirs(folder, exist_ok=True)
        out = os.path.join(folder, "%s_%%d.json" % backend)
        ctx = mp.get_context("spawn")
        ps = [ctx.Process(target=worker, args=(r, 4, 29500 + i, backend, out)) for r in range(4)]
        [p.start() for p in ps]
        [p.join(120) for p in ps]
        for p in ps:
            if p.is_alive(): p.kill()
        print(backend, "%.1f s" % (time.time() - t0), [p.exitcode for p in ps])
        for r in range(4):
            try:
                print(r, open(out % r).read())
            except Exception as e:
                print(r, "no output", e)
