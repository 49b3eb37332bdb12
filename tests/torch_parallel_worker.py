"""One process of a multi-process run of the PyTorch port, for
tests/test_torch_parallel.py: it joins a gloo group through a file store,
runs one mode and writes its results.

    python tests/torch_parallel_worker.py MODE WORLD RANK STORE IN OUT

MODE:
  unit     the collectives (gather_rows, all_reduce_sum and its gradient,
           agree_from_process_zero, sync_processes), synchronised BN and two
           float32 train steps, each process on its shard of the batches
           in IN (torch.save of the parent's tensors and weights);
  eval     Experiment.evaluate of the synthetic test table (15 rows) with
           the weights in IN;
  scan     make_scan_train_step over the batches in IN (groups of
           `steps`, the last one partial), each process on its shard;
  cli      cli.main.main with the arguments in IN (a JSON list), the files
           this process opened for writing under the run's save path
           recorded by an audit hook;
  jaxcli   the JAX package's cli.main.main under jax.distributed, one CPU
           device a process (STORE is then the coordinator's address);
  tp       the grid of --tp (IN's "tp"): its groups, the model-group
           collectives and their gradients, two float32 train steps with a
           sharded mlp head on this process's data shard, the guard with a
           non-finite gradient in one shard, and a NaN batch on the last
           process;
  tp_epoch one epoch of an Experiment with the arguments in IN (a JSON
           list), this process's parameters, the first dropout mask its
           head draws and the generator's state before that draw saved;
  tp_bn    cli.main's Experiment.run with the arguments in IN (a JSON list)
           at --tp: after the epoch's steps the members past model index 0
           shift their BN running statistics (as a GPU's cuDNN may round
           their forward), and every broadcast this process makes is
           recorded with its source and size; its running statistics and
           summary saved.
OUT gets a torch.save (unit, eval) or JSON (cli, jaxcli) of the results.
Only the jaxcli mode imports JAX.
"""

import json
import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(TESTS), TESTS]


def join(world, rank, store):
    import torch

    from zeroshotvideoclassification_tpu_torch.parallel import (
        maybe_initialize,
    )

    torch.set_num_threads(2)
    opened = maybe_initialize(backend="gloo", init_method=f"file://{store}",
                              rank=rank, world_size=world)
    assert opened


def port_model(sd, arch):
    import torch

    from zeroshotvideoclassification_tpu_torch.config import Config
    from zeroshotvideoclassification_tpu_torch.models import get_network

    m = get_network(Config(network=arch, head="mlp"))
    m.load_state_dict(sd, strict=True)
    return m.to(memory_format=torch.channels_last_3d)


def run_unit(world, rank, inp, out):
    import torch

    from zeroshotvideoclassification_tpu_torch.models import layers as PL
    from zeroshotvideoclassification_tpu_torch.parallel import (
        agree_from_process_zero,
        gather_rows,
        sync_processes,
    )
    from zeroshotvideoclassification_tpu_torch.parallel.multihost import (
        all_reduce_,
        all_reduce_sum,
    )
    from zeroshotvideoclassification_tpu_torch.train import (
        make_optimizer,
        make_train_step,
    )
    from torch_helpers import seed_adam

    data = torch.load(inp, weights_only=True)
    res = {}
    # --- the collectives --------------------------------------------------
    rows = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    res["gathered"] = gather_rows(rows)
    x = torch.full((3,), rank + 1.0, requires_grad=True)
    with torch.enable_grad():
        total = all_reduce_sum(x)
        (total * (rank + 1.0)).sum().backward()
    res["reduced"], res["reduced_grad"] = total.detach(), x.grad
    res["agreed"] = agree_from_process_zero(
        "/ckpt/from_p0.npz" if rank == 0 else f"/ckpt/from_p{rank}.npz")
    res["agreed_none"] = agree_from_process_zero(
        None if rank == 0 else "/ckpt/mine.npz")
    sync_processes("same_tag")
    try:
        sync_processes(f"tag_of_{rank}")
        res["mismatch"] = "passed"
    except RuntimeError as e:
        res["mismatch"] = str(e)

    # --- synchronised BN: this process's half of one batch ----------------
    bn_in = data["bn"]
    b = bn_in["x"].shape[0] // world
    sl = slice(rank * b, (rank + 1) * b)
    bn = PL.BatchNorm3d(bn_in["x"].shape[1])
    bn.load_state_dict(bn_in["state"])
    bn.train()
    xs = bn_in["x"][sl].clone().requires_grad_()
    with torch.enable_grad():
        mean, var, new_mean, new_var = PL.bn_statistics(
            xs.detach().permute(0, 2, 3, 4, 1), bn.running_mean,
            bn.running_var, bn.momentum)
        y = bn(xs, relu=True)
        (y * bn_in["cotangent"][sl]).sum().backward()
    grads = [bn.weight.grad.clone(), bn.bias.grad.clone()]
    for g in grads:  # as the train step sums its gradients
        all_reduce_(g)
    res["bn"] = {"mean": mean, "var": var, "new_mean": new_mean,
                 "new_var": new_var, "running_mean": bn.running_mean,
                 "running_var": bn.running_var, "dx": xs.grad,
                 "d_weight": grads[0], "d_bias": grads[1]}

    # --- two float32 train steps on this process's shard -------------------
    st = data["step"]
    m = port_model(st["state_dict"], st["arch"])
    opt = make_optimizer(m.parameters(), st["lr"])
    seed_adam(opt, m, seed=st["adam_seed"], count=st["adam_count"])
    step = make_train_step(m, opt, compute_dtype=torch.float32)
    b = st["batches"][0][0].shape[0] // world
    sl = slice(rank * b, (rank + 1) * b)
    metrics = []
    for x, z, labels, weight in st["batches"]:
        r = step(x[sl], z[sl], labels[sl], weight[sl], st["class_embed"])
        metrics.append((float(r["loss"]), float(r["train_accuracy"])))
    res["step"] = {"metrics": metrics, "count": int(opt.count),
                   "state_dict": {k: v.detach().clone()
                                  for k, v in m.state_dict().items()}}
    torch.save(res, out)


def run_scan(world, rank, inp, out):
    import torch

    from zeroshotvideoclassification_tpu_torch.train import (
        make_optimizer,
        make_scan_train_step,
    )
    from torch_helpers import seed_adam

    st = torch.load(inp, weights_only=True)
    m = port_model(st["state_dict"], st["arch"])
    opt = make_optimizer(m.parameters(), st["lr"])
    seed_adam(opt, m, seed=st["adam_seed"], count=st["adam_count"])
    scan = make_scan_train_step(m, opt, torch.float32, st["steps"])
    b = st["batches"][0][0].shape[0] // world
    sl = slice(rank * b, (rank + 1) * b)
    losses = []
    for start in range(0, len(st["batches"]), st["steps"]):
        group = st["batches"][start:start + st["steps"]]
        for k, batch in enumerate(group):
            scan.stage(k, *[t[sl] for t in batch])
        losses.append(scan.run(len(group), st["class_embed"])["loss"])
    torch.save({"loss": torch.cat(losses), "count": int(opt.count),
                "step": scan.state.step,
                "state_dict": {k: v.detach().clone()
                               for k, v in m.state_dict().items()}}, out)


def run_eval(world, rank, inp, out):
    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as port_main

    data = torch.load(inp, weights_only=True)
    cfg = port_main.config_from_namespace(port_main.build_arg_parser()
                                          .parse_args(data["argv"]))
    table = port_main.build_datasets(cfg, None)["testing"][0]
    exp = port_main.Experiment(cfg, {"training": [], "testing": [table]},
                               device="cpu")
    exp.model.load_state_dict(data["state_dict"])
    seen = {}
    extract = port_main.extract_embeddings

    def counted(*a, **kw):
        got = extract(*a, **kw)
        seen["n_samples"] = len(got[0])
        return got

    port_main.extract_embeddings = counted
    res = exp.evaluate(table, 0)
    exp.log.close()
    torch.save({**res, **seen, "table_rows": len(table),
                "local_rows": len(port_main.shard_table(table))}, out)


def run_cli(world, rank, inp, out):
    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as port_main

    with open(inp) as f:
        argv = json.load(f)
    root = os.path.realpath(argv[argv.index("--save_path") + 1])
    writes = []

    def audit(event, args):
        # every file or directory this process creates, renames or opens
        # to write
        if event == "open":
            mode, flags = args[1], args[2]
            writing = (any(c in (mode or "") for c in "wax+")
                       or (flags or 0) & (os.O_WRONLY | os.O_RDWR
                                          | os.O_CREAT))
            paths = [args[0]] if writing else []
        elif event == "os.mkdir":
            paths = [args[0]]
        elif event in ("os.rename", "os.replace"):
            paths = [args[0], args[1]]
        else:
            return
        for path in paths:
            if (isinstance(path, str)
                    and os.path.realpath(path).startswith(root)):
                writes.append(os.path.relpath(os.path.realpath(path), root))

    sys.addaudithook(audit)
    summary = port_main.main(argv)
    with open(out, "w") as f:
        json.dump({"summary": summary, "writes": writes,
                   "process_count": torch.distributed.get_world_size()}, f)


def run_tp(world, rank, inp, out):
    import torch

    from zeroshotvideoclassification_tpu_torch.models import bridge
    from zeroshotvideoclassification_tpu_torch.parallel import multihost as mh
    from zeroshotvideoclassification_tpu_torch.train import (
        make_optimizer,
        make_train_step,
    )

    data = torch.load(inp, weights_only=True)
    g = mh.init_grid(data["tp"])
    res = {"grid": [g.n_data, g.tp, g.data_index, g.model_index]}
    # --- the collectives ----------------------------------------------------
    res["gather_model"] = mh.gather_model(
        torch.arange(6.0).reshape(2, 3) + 10 * rank, 1)
    res["gather_rows"] = mh.gather_rows(
        torch.arange(6.0).reshape(2, 3) + 10 * g.data_index)
    res["agreed"] = [bool(mh.agree_finite(torch.tensor(rank != 1))),
                     bool(mh.agree_finite(torch.tensor(True)))]
    a = torch.ones(3, requires_grad=True)
    with torch.enable_grad():
        y = mh.reduce_from_model(mh.copy_to_model(a) * (g.model_index + 1.0))
        y.sum().backward()
    res["reduced"], res["copy_grad"] = y.detach(), a.grad

    # --- two float32 steps on this process's data shard ---------------------
    st = data["step"]
    m = port_model(st["state_dict"], st["arch"]).shard_head(g.tp,
                                                           g.model_index)
    opt = make_optimizer(m.parameters(), st["lr"])
    bridge.adam_from_jax(m, opt, st["mu"], st["nu"], st["count"])
    step = make_train_step(m, opt, compute_dtype=torch.float32)
    b = st["batches"][0][0].shape[0] // g.n_data
    sl = slice(g.data_index * b, (g.data_index + 1) * b)
    metrics = []
    for x, z, labels, weight in st["batches"]:
        r = step(x[sl], z[sl], labels[sl], weight[sl], st["class_embed"])
        metrics.append((float(r["loss"]), float(r["train_accuracy"])))

    def snapshot():  # a NaN batch poisons BN's running statistics
        return ({k: v.detach().clone() for k, v in m.named_parameters()},
                {k: (opt.state[p]["exp_avg"].clone(),
                     opt.state[p]["exp_avg_sq"].clone())
                 for k, p in m.named_parameters()}, int(opt.count))

    sd, moments, count = snapshot()
    res["step"] = {"metrics": metrics, "count": count,
                   "state_dict": {k: v.detach().clone()
                                  for k, v in m.state_dict().items()}}

    # --- the guard: a non-finite gradient in the shards of model index 1 ----
    for p in m.parameters():
        p.grad = torch.zeros_like(p)
    if g.model_index == 1:
        m.output2emb_proj.layers[0].weight.grad[0, 0] = float("nan")
    opt.step()
    after = snapshot()
    res["guard"] = {"finite": bool(opt.last_finite),
                    "unchanged": _same((sd, moments, count), after)}

    # --- a NaN in the last process's batch ----------------------------------
    x, z, labels, weight = (t[sl] for t in st["batches"][0])
    if rank == world - 1:
        x = x.clone()
        x[0] = float("nan")
    r = step(x, z, labels, weight, st["class_embed"])
    res["nan"] = {"finite": bool(r["finite"]),
                  "unchanged": _same((sd, moments, count), snapshot())}
    torch.save(res, out)


def _same(a, b):
    """Two snapshots (parameters, moments, count) equal bit for bit."""
    import torch

    (sa, ma, ca), (sb, mb, cb) = a, b
    return (ca == cb and all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for k in ma
                    for x, y in zip(ma[k], mb[k])))


def run_tp_epoch(world, rank, inp, out):
    import torch

    from zeroshotvideoclassification_tpu_torch.cli import main as port_main
    from zeroshotvideoclassification_tpu_torch.models import layers

    with open(inp) as f:
        argv = json.load(f)
    cfg = port_main.config_from_namespace(port_main.build_arg_parser()
                                          .parse_args(argv))
    exp = port_main.Experiment(cfg, port_main.build_datasets(cfg, None),
                               device="cpu")
    first = {}
    drop = layers.dropout

    def recording(x, rate, generator, train):
        if generator is not None and train and rate and not first:
            # the mask this call draws, from a copy of its generator
            state = generator.get_state()
            copy = torch.Generator().set_state(state)
            first.update(state=state, rate=rate,
                         mask=torch.rand(x.shape, generator=copy) < 1 - rate)
        return drop(x, rate, generator, train)

    layers.dropout = recording
    summary = exp.train_one_epoch(0)
    exp.log.close()
    g = exp.grid
    torch.save({"summary": summary, "seed": exp.rng.initial_seed(),
                "grid": [g.n_data, g.tp, g.data_index, g.model_index],
                "first_dropout": first,
                "state_dict": {k: v.detach().clone() for k, v in
                               exp.model.state_dict().items()}}, out)


def run_tp_bn(world, rank, inp, out):
    import torch
    import torch.distributed as dist

    from zeroshotvideoclassification_tpu_torch.cli import main as port_main

    with open(inp) as f:
        argv = json.load(f)
    cfg = port_main.config_from_namespace(port_main.build_arg_parser()
                                          .parse_args(argv))
    exp = port_main.Experiment(cfg, port_main.build_datasets(cfg, None),
                               device="cpu")
    stats = [b for n, b in exp.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    train = exp.train_one_epoch

    def shifted(epoch):
        res = train(epoch)
        if exp.grid.model_index:
            with torch.no_grad():
                for b in stats:
                    b.mul_(1 + 2.0 ** -20)
        return res

    exp.train_one_epoch = shifted
    calls = []
    broadcast = dist.broadcast

    def recording(tensor, src=None, group=None, *a, **kw):
        calls.append({"src": src, "numel": tensor.numel(),
                      "group": None if group is None
                      else dist.get_process_group_ranks(group)})
        return broadcast(tensor, src, group, *a, **kw)

    dist.broadcast = recording
    summary = exp.run()
    dist.broadcast = broadcast
    g = exp.grid
    torch.save({"summary": summary, "broadcasts": calls,
                "stats": [b.clone() for b in stats],
                "grid": [g.n_data, g.tp, g.data_index, g.model_index]}, out)


def run_jaxcli(world, rank, coord, inp, out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    from zeroshotvideoclassification_tpu.cli.main import main as jax_main
    from zeroshotvideoclassification_tpu.parallel.multihost import (
        maybe_initialize,
    )

    maybe_initialize(coordinator_address=coord, num_processes=world,
                     process_id=rank)
    with open(inp) as f:
        argv = json.load(f)
    summary = jax_main(argv)
    with open(out, "w") as f:
        json.dump({"summary": {k: float(v) for k, v in summary.items()},
                   "process_count": jax.process_count(),
                   "device_count": jax.device_count()}, f)


if __name__ == "__main__":
    mode, world, rank, store, inp, out = sys.argv[1:7]
    world, rank = int(world), int(rank)
    if mode == "jaxcli":
        run_jaxcli(world, rank, store, inp, out)
    else:
        join(world, rank, store)
        {"unit": run_unit, "eval": run_eval, "cli": run_cli,
         "scan": run_scan, "tp": run_tp,
         "tp_epoch": run_tp_epoch, "tp_bn": run_tp_bn}[mode](world, rank, inp, out)
