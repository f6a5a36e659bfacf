"""The ranks of ``tests/test_torch_distributed.py``: module-level
functions that ``repro_torch.launch.mesh.spawn_world`` runs in spawned
processes (and ``test_torch_optim.py``'s two-rank all-reduce).  They
live apart from the test module so that a rank imports torch and the port
only: JAX imported in every rank made the worlds several times slower."""
import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch.launch import train as ttrain
from repro_torch.models.base import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init

B, STEPS = 4, 8
# a peak lr at which eight warmup steps (lr up to 0.0175) move the loss
LR = 0.5


def sharded(tcfg, mesh, np_tree):
    """The model on ``mesh`` from whole numpy leaves."""
    from repro_torch import models as tmodels
    from repro_torch.models.base import tree_unflatten
    from repro_torch.sharding import distribute, param_pspecs
    specs = param_pspecs(tmodels.model_struct(tcfg), tcfg, mesh)
    leaves = [distribute(torch.from_numpy(np.array(a)), mesh, s)
              for a, s in zip(tree_leaves(np_tree), tree_leaves(specs),
                              strict=True)]
    return tmodels.Transformer(tcfg, tree_unflatten(specs, leaves))


def full(tree):
    from repro_torch.runtime import full_tensor
    return [full_tensor(t).numpy() for t in tree_leaves(tree)]


def world4(rank, world, trees, batches, ck):
    torch.set_num_threads(1)
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import mesh_config, prefill, prefill_config
    from repro_torch.models.layers import mlp
    from repro_torch.models.base import Params
    from repro_torch.models.shardmap_tp import mlp_tp, o_proj_tp
    from repro_torch.models.transformer import local_params
    from repro_torch.runtime import compressed_allreduce, full_tensor
    from repro_torch.sharding import comm, distribute, local_batch
    from repro_torch.sharding.layout import Layout
    from repro_torch.models.base import PartitionSpec as PS
    mesh = make_host_mesh(2, "cpu")
    out = {}

    # eight training steps
    cfg = mesh_config(tconfigs.get_config("llama3.2-1b", smoke=True), mesh,
                      B)
    model = sharded(cfg, mesh, trees["llama3.2-1b"])
    opt = adamw_init(model.tree)
    step = ttrain.make_step(cfg, AdamWConfig(lr=LR), total_steps=STEPS)
    rows = []
    for i, b in enumerate(batches["llama3.2-1b"]):
        hb = local_batch({k: torch.from_numpy(v) for k, v in b.items()},
                         cfg, mesh)
        model, opt, _, m = step(model, opt, None, hb)
        rows.append([m[k].item() for k in ("loss", "grad_norm", "lr")])
        if i == 0:
            out["grads"] = full(model.grads)
    out["rows"] = rows
    out["params"] = full(model.tree)
    wq = model.tree["segments"][0]["0"]["attn"]["wq"]
    shards = comm.all_gather(wq.to_local()[None], 0, comm.dist.group.WORLD)
    out["wq_placements"] = str(wq.placements)
    out["wq_distinct_shards"] = len({s.numpy().tobytes() for s in shards})

    # the prefill of llama3.2-1b and deepseek-moe-16b (its 8 experts split
    # over 'model'), f32 scores
    for arch in ("llama3.2-1b", "deepseek-moe-16b"):
        pcfg = prefill_config(arch, smoke=True, mesh=mesh,
                              batch=B).replace(attn_dtype="f32")
        pm = sharded(pcfg, mesh, trees[arch])
        toks = torch.from_numpy(batches[arch][0]["tokens"])
        logits, caches = prefill(pm, pcfg, local_batch({"tokens": toks},
                                                       pcfg, mesh))
        out[f"{arch} logits"] = full_tensor(logits).numpy()
        out[f"{arch} k"] = full_tensor(caches[-1]["0"]["k"]).numpy()
        out[f"{arch} k placements"] = str(caches[-1]["0"]["k"].placements)

    # gemma3's chunked attention under forced qseq falls back to dense
    gcfg = prefill_config("gemma3-4b", smoke=True, mesh=mesh, batch=B
                          ).replace(attn_dtype="f32", score_shard="qseq")
    gm = sharded(gcfg, mesh, trees["gemma3-4b"])
    gt = local_batch({"tokens": torch.from_numpy(
        batches["gemma3-4b"][0]["tokens"])}, gcfg, mesh)
    dense = full_tensor(prefill(gm, gcfg, gt)[0]).numpy()
    chunked = full_tensor(prefill(gm, gcfg.replace(attn_impl="chunked"),
                                  gt)[0]).numpy()
    out["qseq dense"], out["qseq chunked"] = dense, chunked

    # mlp_tp and o_proj_tp against mlp and the einsum, as the reference's
    # test_shard_map_tp_mlp_matches_gspmd draws them
    g = torch.Generator().manual_seed(0)
    d, ff = cfg.d_model, cfg.d_ff
    whole = {"w_down": torch.randn(ff, d, generator=g) * 0.05,
             "w_gate": torch.randn(d, ff, generator=g) * 0.05,
             "w_up": torch.randn(d, ff, generator=g) * 0.05}
    specs = {"w_gate": PS("data", "model"), "w_up": PS("data", "model"),
             "w_down": PS("model", "data")}
    p = local_params({k: distribute(v, mesh, specs[k])
                      for k, v in whole.items()})
    x = torch.randn(8, 32, d, generator=g)
    lay = Layout(mesh, batch=True, seq=True)
    rows_x = comm.chunk(comm.chunk(x, 0, lay.data), 1, lay.model)
    want = mlp(Params(whole), x)
    got = comm.all_gather(comm.all_gather(mlp_tp(p, rows_x, cfg, lay), 1,
                                          lay.model), 0, lay.data)
    out["mlp_tp_err"] = (got - want).abs().max().item()
    oh = torch.randn(8, 32, 8, 4, generator=g)
    wo = torch.randn(8, 4, d, generator=g) * 0.05
    want = torch.einsum("bshk,hkd->bsd", oh, wo)
    mine = comm.chunk(comm.chunk(oh, 0, lay.data), 2, lay.model)
    got = o_proj_tp(mine, comm.chunk(wo, 0, lay.model), cfg, lay)
    got = comm.all_gather(comm.all_gather(got, 1, lay.model), 0, lay.data)
    out["o_proj_tp_err"] = (got - want).abs().max().item()

    # compressed_allreduce of one tensor on every rank, over 'data' of a
    # 4-rank mesh
    from torch.distributed.device_mesh import init_device_mesh
    flat = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    xc = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4099).astype(np.float32))
    out["compressed"] = compressed_allreduce(xc, flat, "data").numpy()

    # smoke rwkv6-3b at (2, 2): its 4 heads divide the model axis
    out["rwkv6-3b"] = recurrent_runs(mesh, "rwkv6-3b", trees["rwkv6-3b"],
                                     batches["rwkv6-3b"])

    # the (2, 2) checkpoint of the initial llama parameters
    save_checkpoint(ck, 1, sharded(cfg, mesh, trees["llama3.2-1b"]).tree,
                    process_index=rank, process_count=world)
    comm.dist.barrier()
    return out if rank == 0 else None


def world2(rank, world, ck, tree, ck_train):
    torch.set_num_threads(1)
    from repro_torch import models as tmodels
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.runtime import survivors_mesh
    from repro_torch.sharding import param_pspecs, placements
    from repro_torch.models.base import tree_map
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    mesh = survivors_mesh(list(range(world)), ("data", "model"), 2,
                          device="cpu")
    struct = tmodels.model_struct(cfg)
    specs = param_pspecs(struct, cfg, mesh)
    like = tree_map(lambda p: torch.empty(p.shape, device="meta"), struct)
    got = restore_checkpoint(ck, 1, like, shardings=specs, mesh=mesh)
    placed = [list(t.placements) == placements(mesh, s)
              for t, s in zip(tree_leaves(got), tree_leaves(specs))]
    res = ttrain.train("llama3.2-1b", smoke=True, steps=6, batch=4, seq=32,
                       compress=True, lr=1e-2, log_every=1000,
                       ckpt_dir=ck_train, ckpt_every=3, model_axis=2,
                       device="cpu")
    out = {"mesh": list(mesh.mesh.shape), "placed": placed,
           "leaves": full(got), "losses": res["losses"],
           "train_params": full(res["params"])}
    return out if rank == 0 else None


def world8(rank, world, trees, toks, batches):
    """(1, 8): smoke gemma3-4b's 4 heads do not divide the model axis
    (qseq): its prefill dense, chunked and through K3's twin on each
    rank's own query rows; the recurrent archs (:func:`recurrent_runs`)
    and the K4 / K5 layers on a rank's share (:func:`kernel_shares`)."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import prefill, prefill_config
    from repro_torch.runtime import full_tensor
    from repro_torch.sharding import local_batch
    mesh = make_host_mesh(8, "cpu")
    cfg = prefill_config("gemma3-4b", smoke=True, mesh=mesh, batch=2
                         ).replace(attn_dtype="f32")
    model = sharded(cfg, mesh, trees["gemma3-4b"])
    mine = local_batch({"tokens": torch.from_numpy(toks)}, cfg, mesh)
    dense, caches = prefill(model, cfg, mine)
    chunked = prefill(model, cfg.replace(attn_impl="chunked"), mine)[0]
    flash = prefill(model, cfg.replace(attn_impl="flash"), mine)[0]
    out = {"score_shard": cfg.score_shard, "kv_shard": cfg.kv_shard,
           "dense": full_tensor(dense).numpy(),
           "chunked": full_tensor(chunked).numpy(),
           "flash": full_tensor(flash).numpy(),
           "wq": str(model.tree["segments"][0]["0"]["attn"]["wq"].placements),
           "k": str(caches[0]["0"]["k"].placements)}
    for arch in ("recurrentgemma-2b", "rwkv6-3b"):
        out[arch] = recurrent_runs(mesh, arch, trees[arch], batches[arch])
    out["kernel shares"] = kernel_shares(mesh, trees)
    return out if rank == 0 else None


# decode steps of the recurrent runs, from zeroed caches of this length
DECODE_STEPS, DECODE_LEN = 4, 8


def recurrent_runs(mesh, arch, tree, batches):
    """Smoke ``arch`` on ``mesh`` from the f32 leaves ``tree``: the prefill
    of ``batches[0]``'s tokens (f32 scores; logits and last caches
    gathered, the caches' placements), two ``make_step`` steps on
    ``batches[:2]`` (rows of loss, grad norm and lr; the parameters
    after them, gathered) and ``DECODE_STEPS`` steps of ``decode_cell``
    over the first tokens of ``batches[0]`` from zeroed caches (the
    logits of each step, gathered)."""
    from repro_torch.configs import Shape
    from repro_torch.launch.steps import (decode_cell, mesh_config, prefill,
                                          prefill_config)
    from repro_torch.models.base import tree_unflatten
    from repro_torch.runtime import full_tensor
    from repro_torch.sharding import distribute, local_batch
    toks = torch.from_numpy(batches[0]["tokens"])
    out = {}
    pcfg = prefill_config(arch, smoke=True, mesh=mesh, batch=B
                          ).replace(attn_dtype="f32")
    logits, caches = prefill(sharded(pcfg, mesh, tree), pcfg,
                             local_batch({"tokens": toks}, pcfg, mesh))
    out["prefill"] = full_tensor(logits).numpy()
    out["caches"] = {name: full_tensor(t).numpy()
                     for name, t in caches[-1]["0"].items()}
    out["cache placements"] = {name: str(t.placements)
                               for name, t in caches[-1]["0"].items()}
    out["score_shard"] = pcfg.score_shard

    cfg = mesh_config(tconfigs.get_config(arch, smoke=True), mesh, B)
    model = sharded(cfg, mesh, tree)
    opt = adamw_init(model.tree)
    step = ttrain.make_step(cfg, AdamWConfig(lr=LR), total_steps=2)
    rows = []
    for b in batches[:2]:
        hb = local_batch({k: torch.from_numpy(v) for k, v in b.items()},
                         cfg, mesh)
        model, opt, _, m = step(model, opt, None, hb)
        rows.append([m[k].item() for k in ("loss", "grad_norm", "lr")])
    out["rows"], out["params"] = rows, full(model.tree)

    cell = decode_cell(tconfigs.get_config(arch, smoke=True),
                       Shape("decode", DECODE_LEN, B, "decode"), mesh)
    pspec, cspec = cell.in_shardings[:2]
    params = tree_unflatten(cell.args[0], [
        distribute(torch.from_numpy(np.array(a)), mesh, s)
        for a, s in zip(tree_leaves(tree), tree_leaves(pspec), strict=True)])
    dcaches = [tree_unflatten(c, [
        distribute(torch.zeros(t.shape), mesh, sp)
        for t, sp in zip(tree_leaves(c), tree_leaves(cs))])
        for c, cs in zip(cell.args[1], cspec)]
    steps = []
    for pos in range(DECODE_STEPS):
        logits, dcaches = cell.fn(params, dcaches, toks[:, pos:pos + 1], pos)
        steps.append(full_tensor(logits).numpy())
    out["decode"] = np.stack(steps)
    return out


def kernel_shares(mesh, trees):
    """K4's and K5's twins on a rank's share against the whole width, and
    the RG-LRU and RWKV-6 layers with ``use_kernel=True`` on the mesh
    against the one-rank layer (f32, smoke layer 0's weights; gathered)."""
    from repro_torch.kernels import ops
    from repro_torch.models import recurrent
    from repro_torch.models.layers import embed
    from repro_torch.sharding import comm
    from repro_torch.sharding.layout import Layout
    lay = Layout(mesh, batch=False, seq=True)
    tp, r = lay.tp, lay.tp_rank
    g = torch.Generator().manual_seed(1)
    out = {}
    a = torch.rand(2, 24, 64, generator=g) * 0.5 + 0.5
    b = torch.randn(2, 24, 64, generator=g)
    c = 64 // tp
    mine = ops.rglru_scan(a[..., r * c:(r + 1) * c], b[..., r * c:(r + 1) * c])
    whole = ops.rglru_scan(a, b)[..., r * c:(r + 1) * c]
    out["k4 share bit-equal"] = bool(comm.all_reduce(torch.tensor(
        float(not torch.equal(mine, whole))), lay.model).item() == 0)
    # K5 on the heads a rank's channels touch, v zero outside them
    rk, kk, vk, wk = (torch.randn(2, 24, 4, 16, generator=g)
                      for _ in range(4))
    wk = torch.exp(-torch.exp(wk.clamp(-8.0, 4.0)))
    u = torch.randn(4, 16, generator=g) * 0.1
    c0, c1 = r * c, (r + 1) * c
    h0, h1 = c0 // 16, -(-c1 // 16)
    vz = torch.zeros_like(vk.reshape(2, 24, 64))
    vz[..., c0:c1] = vk.reshape(2, 24, 64)[..., c0:c1]
    vz = vz.reshape(2, 24, 4, 16)
    o_mine, s_mine = ops.rwkv6_scan(rk[:, :, h0:h1], kk[:, :, h0:h1],
                                    vz[:, :, h0:h1], wk[:, :, h0:h1],
                                    u[h0:h1])
    o_whole, s_whole = ops.rwkv6_scan(rk, kk, vk, wk, u)
    o_mine = o_mine.reshape(2, 24, -1)[..., c0 - h0 * 16:c1 - h0 * 16]
    o_whole = o_whole.reshape(2, 24, 64)[..., c0:c1]
    s_mine = s_mine.transpose(1, 2).reshape(2, 16, -1)[
        ..., c0 - h0 * 16:c1 - h0 * 16]
    s_whole = s_whole.transpose(1, 2).reshape(2, 16, 64)[..., c0:c1]
    out["k5 share bit-equal"] = bool(comm.all_reduce(torch.tensor(float(
        not (torch.equal(o_mine, o_whole) and torch.equal(s_mine, s_whole)))),
        lay.model).item() == 0)
    for arch, fn, sub in (("recurrentgemma-2b", recurrent.rglru, "rglru"),
                          ("rwkv6-3b", recurrent.rwkv6_time_mix, "tm")):
        cfg = tconfigs.get_config(arch, smoke=True)
        model = sharded(cfg.replace(act_shard="seq"), mesh, trees[arch])
        one = sharded_one(cfg, trees[arch])
        toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
        x = embed(one.embed, toks, cfg)
        lp = getattr(model.segments[0][0], "0")
        lp1 = getattr(one.segments[0][0], "0")
        with torch.inference_mode():
            got, state = fn(getattr(lp, sub), comm.chunk(x, 1, lay.model),
                            cfg=cfg, use_kernel=True, lay=lay)
            want, want_state = fn(getattr(lp1, sub), x, cfg=cfg,
                                  use_kernel=True)
            got = comm.all_gather(got, 1, lay.model)
            state = {n: comm.all_gather(t, t.dim() - 1, lay.model)
                     for n, t in state.items()}
        if sub == "tm":       # the one-rank wkv state, value-major
            want_state["wkv"] = want_state["wkv"].transpose(1, 2).reshape(
                2, 16, 64)
        out[arch] = {"out_err": (got - want).abs().max().item(),
                     "out_max": want.abs().max().item(),
                     "state_err": max((state[n] - want_state[n]).abs().max()
                                      .item() for n in want_state)}
    return out


def sharded_one(tcfg, np_tree):
    """The model on one rank from whole numpy leaves."""
    from repro_torch import models as tmodels
    from repro_torch.models.base import tree_unflatten
    specs = tmodels.model_struct(tcfg)
    return tmodels.Transformer(tcfg, tree_unflatten(specs, [
        torch.from_numpy(np.array(a)) for a in tree_leaves(np_tree)]))


def arange_result(rank, world):
    """A rank's result holding a tensor (``spawn_world``'s rank results)."""
    return {"rank": rank, "t": torch.arange(1000, dtype=torch.float32)}


def compress_two(rank, world, xs):
    """``compressed_allreduce`` of rank r's row of ``xs`` over 'data'."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime import compressed_allreduce
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    return compressed_allreduce(torch.from_numpy(xs[rank]), mesh,
                                "data").numpy()


TRAIN_MODES = {"fsdp": {}, "mb2": {"microbatches": 2},
               "zero1": {"param_mode": "zero1"}}


def train_cell_runs(mesh, leaves, batch, shape):
    """One step of smoke llama3.2-1b's ``train_cell`` (f32 scores) in each
    of :data:`TRAIN_MODES` from the f32 ``leaves``: (loss, grad norm, the
    updated f32 parameters (the master in zero1), gathered)."""
    from repro_torch.launch.steps import train_cell
    from repro_torch.models.base import tree_unflatten
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import full_tensor
    from repro_torch.sharding import distribute
    out = {}
    for mode, kw in TRAIN_MODES.items():
        cell = train_cell(tconfigs.get_config("llama3.2-1b", smoke=True),
                          shape, mesh, attn_dtype="f32", **kw)
        pspec, ospec = cell.in_shardings[:2]
        master = ospec["master"] if mode == "zero1" and mesh else pspec

        def tree(dtype, spec):
            ts = [torch.from_numpy(np.array(a)).to(dtype) for a in leaves]
            if mesh is not None:
                ts = [distribute(t, mesh, s)
                      for t, s in zip(ts, tree_leaves(spec))]
            return tree_unflatten(cell.args[0], ts)

        if mode == "zero1":
            params = tree(torch.bfloat16, pspec)
            opt = dict(adamw_init(tree(torch.float32, master)),
                       master=tree(torch.float32, master))
        else:
            params = tree(torch.float32, pspec)
            opt = adamw_init(params)
        hb = {k: torch.from_numpy(v) for k, v in batch.items()}
        params, opt, m = cell.fn(params, opt, hb)
        w = opt["master"] if mode == "zero1" else params
        out[mode] = (m["loss"].item(), m["grad_norm"].item(),
                     [full_tensor(t).numpy() for t in tree_leaves(w)])
    return out


def lora_combine(mesh, tokens: int = 64):
    """rwkv6-3b's LoRA interpolation weights (``recurrent._lora_mu``) at
    full width (d 2560, a LoRA width of 160: 40 a rank at (1, 4)) on 1 x
    ``tokens`` rows, on ``mesh`` and on one rank, in f32 and bf16; and,
    for the bf16 ones, the sum that the same bf16 operands' products make
    without rounding (each rank's partial and their sum in f32) and the
    bound of the mesh's roundings (each rank's partial rounded to bf16,
    then tp - 1 bf16 additions, then mu_base added: within
    ``(tp + 1) u`` of the partials' absolute sum plus ``u |mu|``, u =
    2^-8).  Whole tensors on every rank."""
    from repro_torch.models import init_params, recurrent
    from repro_torch.models.base import Params, partition_specs
    from repro_torch.models.layers import _w
    from repro_torch.models.transformer import local_params
    from repro_torch.sharding import comm
    from repro_torch.sharding.layout import Layout, mark, shard_of
    from repro_torch.sharding.specs import logical_rules
    cfg = tconfigs.get_config("rwkv6-3b")
    tm = recurrent.rwkv6_struct(cfg)["tm"]
    struct = {n: tm[n] for n in ("mu_base", "lora_a", "lora_b")}
    lay = Layout(mesh, batch=False, seq=True)
    mine = local_params(init_params(
        struct, torch.Generator().manual_seed(3), device="cpu", mesh=mesh,
        specs=partition_specs(struct, logical_rules(cfg, mesh))))
    whole = init_params(struct, torch.Generator().manual_seed(3),
                        device="cpu")
    x = torch.randn((1, tokens, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    def cast(p, dt):             # keeps each shard's mesh marks
        out = Params({n: getattr(p, n).to(dt) for n in struct})
        for n in struct:
            mark(getattr(out, n), shard_of(getattr(p, n)))
        return out

    out = {"tp": lay.tp}
    with torch.inference_mode():
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            out[f"one_{name}"] = recurrent._lora_mu(
                Params({n: t.to(dt) for n, t in whole.items()}), x.to(dt),
                None).float()
            out[f"mesh_{name}"] = recurrent._lora_mu(
                cast(mine, dt), x.to(dt), lay).float()
        # the bf16 operands' partial products, unrounded
        p = cast(mine, torch.bfloat16)
        lx = torch.tanh(x.to(torch.bfloat16) @ _w(p, "lora_a", lay)).float()
        part = torch.einsum("bsl,nld->nbsd", lx, _w(p, "lora_b", lay).float())
        out["exact_bf16"] = comm.all_reduce(part, lay.model) + _w(
            p, "mu_base", lay).float()[:, None, None, :]
        out["partials_abs"] = comm.all_reduce(part.abs(), lay.model)
    return {k: v if k == "tp" else v.numpy() for k, v in out.items()}


def cells_world(rank, world, cases, tokens, seed, train):
    """The cells on meshes of this world of 4 CPU ranks.

    Decode: for each case (name, arch, mesh shape, batch, cache length),
    ``decode_cell``'s step on smoke params drawn from ``seed`` (f32), from
    zeroed caches laid out by ``cache_pspecs``, one step for each column
    of ``tokens[name]``: the logits of every step, gathered, and the
    caches' placements.  Training: :func:`train_cell_runs` at (2, 2) and
    at (1, 4) on ``train`` = (leaves, batch, shape).  At (1, 4) the smoke
    model's 8 q heads divide the model axis and its 2 kv heads do not,
    so a rank projects its head_dim slice of both kv heads and
    all-gathers it (``layers._kv_heads``): that layout's prefill of
    ``batch``'s tokens from ``leaves`` (f32 scores) too, its logits and
    last caches gathered, and ``wk``'s placements."""
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import Shape
    from repro_torch.launch.steps import decode_cell
    from repro_torch.models import init_params, model_struct
    from repro_torch.models.base import tree_unflatten
    from repro_torch.runtime import full_tensor
    from repro_torch.sharding import distribute
    out = {}
    for name, arch, shape, batch, max_len in cases:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        cell = decode_cell(tconfigs.get_config(arch, smoke=True),
                           Shape(name, max_len, batch, "decode"), mesh)
        pspec, cspec = cell.in_shardings[:2]
        params = init_params(model_struct(cell.cfg),
                             torch.Generator().manual_seed(seed),
                             mesh=mesh, specs=pspec, device="cpu")
        caches = [tree_unflatten(c, [
            distribute(torch.zeros(t.shape), mesh, s)
            for t, s in zip(tree_leaves(c), tree_leaves(sp))])
            for c, sp in zip(cell.args[1], cspec)]
        steps = []
        for pos in range(tokens[name].shape[1]):
            tok = torch.from_numpy(tokens[name][:, pos:pos + 1])
            logits, caches = cell.fn(params, caches, tok, pos)
            steps.append(full_tensor(logits).numpy())
        k = caches[-1]["0"]["k"]
        out[name] = {"logits": np.stack(steps), "k": str(k.placements),
                     "k_local": list(k.to_local().shape)}
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out["train"] = train_cell_runs(mesh, *train)
    from repro_torch.launch.steps import prefill, prefill_config
    from repro_torch.sharding import local_batch
    leaves, batch, shape = train
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    out["train_1x4"] = train_cell_runs(mesh, *train)
    out["lora_combine_1x4"] = lora_combine(mesh)
    pcfg = prefill_config("llama3.2-1b", smoke=True, mesh=mesh,
                          batch=shape.global_batch).replace(attn_dtype="f32")
    model = sharded(pcfg, mesh, leaves)
    logits, caches = prefill(model, pcfg, local_batch(
        {"tokens": torch.from_numpy(batch["tokens"])}, pcfg, mesh))
    out["prefill_1x4"] = {
        "logits": full_tensor(logits).numpy(),
        "k": full_tensor(caches[-1]["0"]["k"]).numpy(),
        "v": full_tensor(caches[-1]["0"]["v"]).numpy(),
        "wk": str(model.tree["segments"][0]["0"]["attn"]["wk"].placements)}
    return out if rank == 0 else None
