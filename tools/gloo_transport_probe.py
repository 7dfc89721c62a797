"""Times one large gloo all_to_all_single among 4 ranks on one GPU, the
size of a fleet's feature-rows round (1.69 GB a rank, phase 14 of
chip_smoke.py): as one op on CUDA tensors and on pinned host tensors, and
split into k chunks sent concurrently over k process groups (k = 2, 4,
8).  Prints rank 0's wall ms of 3 repetitions of each.

    python3 tools/gloo_transport_probe.py      # on a machine with a GPU
"""
import json, os, socket, time
import torch, torch.distributed as td
import torch.multiprocessing as mp

NB = 1_689_600_000

def run(rank, world, port, q):
    td.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                          rank=rank, world_size=world)
    torch.cuda.set_device(0)
    res = {}
    x = torch.randn(world, NB // 4 // world, device="cuda")
    def timeit(fn, name, reps=3):
        ts = []
        for _ in range(reps):
            td.barrier(); torch.cuda.synchronize()
            t0 = time.perf_counter(); fn(); torch.cuda.synchronize()
            ts.append(round((time.perf_counter() - t0) * 1e3, 1))
        res[name] = ts
    out = torch.empty_like(x)
    timeit(lambda: td.all_to_all_single(out, x), "one op cuda")
    xh = x.cpu().pin_memory(); oh = torch.empty_like(xh).pin_memory()
    timeit(lambda: td.all_to_all_single(oh, xh), "one op host")
    for k in (2, 4, 8):
        pgs = [td.new_group(list(range(world))) for _ in range(k)]
        chunks = [c.contiguous() for c in x.chunk(k, dim=1)]
        outs = [torch.empty_like(c) for c in chunks]
        def par():
            ws = [td.all_to_all_single(o, c, group=g, async_op=True)
                  for o, c, g in zip(outs, chunks, pgs)]
            for w in ws: w.wait()
        timeit(par, f"{k} groups cuda")
        hch = [c.cpu().pin_memory() for c in chunks]
        hout = [torch.empty_like(c).pin_memory() for c in hch]
        def parh():
            ws = [td.all_to_all_single(o, c, group=g, async_op=True)
                  for o, c, g in zip(hout, hch, pgs)]
            for w in ws: w.wait()
        timeit(parh, f"{k} groups host")
    if rank == 0:
        q.put(res)
    td.barrier()
    td.destroy_process_group()

if __name__ == "__main__":
    print(torch.__version__, torch.cuda.get_device_name(0), os.cpu_count(), flush=True)
    ctx = mp.get_context("spawn")
    s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
    q = ctx.Queue()
    procs = [ctx.Process(target=run, args=(r, 4, port, q)) for r in range(4)]
    for p in procs: p.start()
    print(json.dumps(q.get(timeout=500)), flush=True)
    for p in procs: p.join(timeout=60)
