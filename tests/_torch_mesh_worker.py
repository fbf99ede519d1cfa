"""One rank of the port's mesh-parallel tests (a Gloo group on the CPU).

    python tests/_torch_mesh_worker.py SUITE RANK WORLD PORT WORKDIR

SUITE is ``tp`` (tests/test_torch_tensor_parallel.py), ``serving``
(tests/test_torch_serving_parallel.py), ``pipeline``
(tests/test_torch_pipeline.py) or ``ring`` (tests/test_torch_ring_attention.py).
Waits for ``WORKDIR/inputs.pt`` (weights, batches and settings the test
writes while the ranks start), joins the group over
``tcp://localhost:PORT``, runs every case of the suite and writes
``WORKDIR/rank{R}.pt`` ({case: result}, or {"error": traceback}) for the
test to hold against the JAX package.  Imports no JAX.
"""

import faulthandler
import os
import sys
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_concept_learning_tpu_torch.parallel import collectives as col  # noqa: E402
from multimodal_concept_learning_tpu_torch.parallel import multihost  # noqa: E402
from multimodal_concept_learning_tpu_torch.parallel import sharding_rules as sr  # noqa: E402
from multimodal_concept_learning_tpu_torch.parallel.mesh import (  # noqa: E402
    batch_sharding,
    make_mesh,
)


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _full(model):
    """Rank-independent full parameters (numpy) of a sharded model."""
    return {k: _np(v) for k, v in multihost.host_fetchable(model).items()}


def _rank0(rank, value):
    """``value`` (computed collectively on every rank) kept on rank 0 only."""
    return value if rank == 0 else None


def _stripe(batch, mesh, axes):
    place = batch_sharding(mesh, axes)
    return {k: place.local(torch.as_tensor(v)) for k, v in batch.items()}


def _mllm(cfg, sd):
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm

    return build_mllm(cfg, {k: v.clone() for k, v in sd.items()}, "cpu")


def _stepped(make_step, model, batch, lr, hp):
    """One train step of ``make_step(model)`` under AdamW: its metrics and
    the full gradients it took, recorded before the update."""
    from multimodal_concept_learning_tpu_torch.parallel import train_step as ts
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer

    opt = build_optimizer(model, lr, **hp)
    update, seen = opt.step, {}

    def step():
        seen.update(_grads(model))
        return update()

    opt.step = step
    _, metrics = make_step(model)(ts.TrainState(model=model, optimizer=opt), batch)
    return metrics, seen


def _train_step(model, batch, lr, hp, setting=None):
    """The MLLM train step: (loss, the gradients before the update)."""
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask
    from multimodal_concept_learning_tpu_torch.parallel import train_step as ts

    if setting is not None:
        trainable_mask(model, setting)
    metrics, grads = _stepped(ts.make_mllm_train_step, model, batch, lr, hp)
    return float(metrics["loss"]), grads


def _grads(model, reduce=True):
    """Full (all-gathered) gradients by state-dict name, after the data
    reduction ``Optimizer.step`` applies (``reduce``: the data ranks hold
    different rows), on copies: the parameters' ``.grad`` stay as they are."""
    params = {sr.canonical_name(n): p for n, p in model.named_parameters() if p.requires_grad}
    names = sorted(params)
    grads = [params[n].grad.clone() if params[n].grad is not None
             else torch.zeros_like(params[n]) for n in names]
    if reduce:
        multihost.reduce_gradients(grads, [params[n] for n in names])
    out = {}
    for n, g in zip(names, grads):
        g._mcl_shard = params[n]._mcl_shard
        out[n] = _np(sr.gather_full(g))
    return out


# -- tensor, fully-sharded and expert parallelism --------------------------------------


def tp_cases(inp, rank):
    from multimodal_concept_learning_tpu_torch.checkpoint_io import (
        restore_checkpoint,
        save_checkpoint,
    )
    from multimodal_concept_learning_tpu_torch.models.lm import CausalLM
    from multimodal_concept_learning_tpu_torch.models.vit import ViTForImageClassification
    from multimodal_concept_learning_tpu_torch.ops.losses import answer_count
    from multimodal_concept_learning_tpu_torch.parallel import train_step as ts
    from multimodal_concept_learning_tpu_torch.parallel.serving import make_sharded_generate

    m = inp["mllm"]
    out = {}
    meshes = {"tp": ((2, 2), ("data", "model"), None), "fsdp": ((4,), ("data",), "data"),
              "tp_fsdp": ((2, 2), ("data", "model"), "data")}
    for case, (shape, names, fsdp) in meshes.items():
        mesh = make_mesh("cpu", names, shape)
        model = sr.shard_params(_mllm(m["cfg"], m["sd"]), mesh, fsdp_axis=fsdp)
        emb = model.language_model.model.embed_tokens
        emb_local = sr.local_tensors(model)["language_model.model.embed_tokens.weight"]
        batch = _stripe(m["batch"], mesh, ("data",))
        loss, grads = _train_step(model, batch, m["lr"], m["hp"], m["setting"])
        out[case] = dict(loss=loss, params=_rank0(rank, _full(model)),
                         step_grads=_rank0(rank, grads), emb_rows=int(emb_local.shape[0]),
                         emb_tp=getattr(emb, "_tp", None) is not None,
                         specs=sr.param_shardings(model, mesh, fsdp_axis=fsdp))

    # the gradients of the TP + FSDP step, before any update
    mesh = make_mesh("cpu", ("data", "model"), (2, 2))
    model = sr.shard_params(_mllm(m["cfg"], m["sd"]), mesh, fsdp_axis="data")
    batch = _stripe(m["batch"], mesh, ("data",))
    count = multihost.all_reduce_sum(answer_count(batch["labels"], m["cfg"].max_answer_tokens),
                                     multihost.data_group(model))
    res = model(batch["images"], batch["input_ids"], batch["attention_mask"], batch["labels"],
                loss_count=count)
    res["loss"].backward()
    out["grads"] = _rank0(rank, _grads(model))

    # the classifier step on a TP + FSDP mesh (ViT MLP column/row parallel)
    c = inp["classifier"]
    mesh = make_mesh("cpu", ("data", "model"), (2, 2))
    clf = ViTForImageClassification(c["cfg"])
    clf.load_state_dict(c["sd"])
    sr.shard_params(clf, mesh, fsdp_axis="data")
    metrics, grads = _stepped(ts.make_classifier_train_step, clf,
                              _stripe(c["batch"], mesh, ("data",)), c["lr"], c["hp"])
    out["classifier"] = dict(loss=float(metrics["loss"]), count=int(metrics["count"]),
                             params=_rank0(rank, _full(clf)), step_grads=_rank0(rank, grads),
                             tp=getattr(clf.vit.encoder.layer[0].intermediate["dense"], "_tp",
                                        None) is not None)

    # the LoRA step (language_lora) on TP + FSDP
    lo = inp["lora"]
    mesh = make_mesh("cpu", ("data", "model"), (2, 2))
    model = sr.shard_params(_mllm(lo["cfg"], lo["sd"]), mesh, fsdp_axis="data")
    loss, grads = _train_step(model, _stripe(lo["batch"], mesh, ("data",)), lo["lr"], lo["hp"],
                              "language_lora")
    out["lora"] = dict(loss=loss, params=_rank0(rank, _full(model)),
                       step_grads=_rank0(rank, grads))

    # expert parallelism: dense and sparse dispatch, the batch replicated
    for case in ("ep_dense", "ep_sparse"):
        e = inp[case]
        mesh = make_mesh("cpu", ("data", "model"), (2, 2))
        lm = CausalLM(e["cfg"])
        lm.load_state_dict(e["sd"])
        sr.shard_params(lm, mesh)
        ids = torch.as_tensor(e["ids"])
        hidden = lm.hidden_states(lm.embed(ids), torch.ones_like(ids))
        loss = (lm.lm_head(hidden).float() ** 2).mean()
        loss.backward()
        experts = sr.local_tensors(lm)["model.layers.0.moe.experts_gate"]
        out[case] = dict(loss=float(loss), grads=_rank0(rank, _grads(lm, reduce=False)),
                         local_experts=int(experts.shape[0]))

    # hybrid meshes: one slice of (2 data x 2 model) with FSDP; two slices of (1 x 2)
    h = inp["hybrid"]
    for case, (ici, slices) in {"hybrid_fsdp": ((2, 2), 1), "hybrid_replica": ((1, 2), 2)}.items():
        mesh = multihost.make_hybrid_mesh(ici, ("data", "model"), num_slices=slices,
                                          device_type="cpu")
        model = sr.shard_params(_mllm(h["cfg"], h["sd"]), mesh, fsdp_axis="data")
        batch = _stripe(h["batch"], mesh, multihost.dp_axes(mesh))
        loss, grads = _train_step(model, batch, h["lr"], h["hp"], h["setting"])
        out[case] = dict(loss=loss, params=_rank0(rank, _full(model)),
                         step_grads=_rank0(rank, grads), axes=tuple(mesh.mesh_dim_names),
                         shape=tuple(mesh.shape), dp_axes=multihost.dp_axes(mesh),
                         stripe=multihost.dp_stripe(mesh))
        if case == "hybrid_fsdp":
            # host_fetchable, then a save and resume of the shards (rank 0 writes)
            full = multihost.host_fetchable(model)
            finite = all(bool(torch.isfinite(v.float()).all()) for v in full.values())
            before = {k: v.clone() for k, v in sr.local_tensors(model).items()}
            if multihost.is_main_process():
                save_checkpoint(inp["ckpt_dir"], full, step=1, wait=True)
            multihost.barrier()
            restored, step = restore_checkpoint(inp["ckpt_dir"])
            with torch.no_grad():
                for t in sr.local_tensors(model).values():
                    t.zero_()
            sr.load_full_state_dict(model, restored)
            after = sr.local_tensors(model)
            out["save_restore"] = dict(finite=finite, step=step, bitwise=all(
                torch.equal(before[k], after[k]) for k in before),
                shapes_kept=all(before[k].shape == after[k].shape for k in before))

    # the CLIP train step on TP + FSDP (the vision tower's MLP column/row parallel)
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPModel

    cp = inp["clip"]
    mesh = make_mesh("cpu", ("data", "model"), (2, 2))
    clip = CLIPModel(cp["cfg"])
    clip.load_state_dict(cp["sd"])
    sr.shard_params(clip, mesh, fsdp_axis="data")
    metrics, grads = _stepped(ts.make_clip_train_step, clip,
                              _stripe(cp["batch"], mesh, ("data",)), cp["lr"], cp["hp"])
    out["clip"] = dict(loss=float(metrics["loss"]), params=_rank0(rank, _full(clip)),
                       step_grads=_rank0(rank, grads))

    # CLIP's InfoNCE over a batch striped on 4 data ranks (JAX's axis_name)
    from multimodal_concept_learning_tpu_torch.models.clip import contrastive_loss

    cl = inp["clip_loss"]
    mesh = make_mesh("cpu", ("data",), (4,))
    group = col.mesh_group(mesh, "data")
    img, txt = (batch_sharding(mesh, "data").local(torch.as_tensor(cl[k])).clone()
                .requires_grad_() for k in ("img", "txt"))
    loss = contrastive_loss(img, txt, torch.tensor(cl["scale"]), group)
    loss.backward()
    out["clip_loss"] = dict(loss=float(loss), img_grad=_np(img.grad), txt_grad=_np(txt.grad))

    # TP-sharded greedy decode (2 data x 2 model) == single-process greedy
    mesh = make_mesh("cpu", ("data", "model"), (2, 2))
    gen, _ = make_sharded_generate(_mllm(h["cfg"], h["sd"]), mesh, h["n_new"])
    b = h["batch"]
    out["decode"] = _np(gen(b["images"], b["input_ids"], b["attention_mask"])).astype(np.int64)
    out["counts"] = dict(col.COUNTS)
    return out


# -- sharded serving ---------------------------------------------------------------------


def serving_cases(inp, rank):
    from multimodal_concept_learning_tpu_torch.parallel.serving import (
        make_sharded_generate,
        make_sharded_paged_generate,
    )
    from multimodal_concept_learning_tpu_torch.serve.continuous import (
        ContinuousBatcher,
        ContinuousEngine,
    )
    from multimodal_concept_learning_tpu_torch.serve.loader import LoadedMLLM
    from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

    out = {}
    images, ids, mask = (inp["prompt"][k] for k in ("images", "ids", "mask"))
    n_new = inp["n_new"]
    mesh = make_mesh("cpu", ("data", "model"), (2, 2))
    gen, model = make_sharded_generate(_mllm(inp["cfg"], inp["sd"]), mesh, n_new)
    col.reset_counts()
    out["generate"] = _np(gen(images, ids, mask)).astype(np.int64)
    out["generate_counts"] = dict(col.COUNTS)
    out["gate_sharded"] = (sr.local_tensors(model)[
        "language_model.model.layers.0.mlp.gate_proj.weight"].shape[0]
        < inp["cfg"].lm.intermediate_size)
    out["local_heads"] = (model.cfg.lm.num_heads, model.cfg.lm.num_kv_heads)

    mesh = make_mesh("cpu", ("data", "model"), (2, 2))
    gen, _ = make_sharded_generate(_mllm(inp["qcfg"], inp["qsd"]), mesh, inp["n_new_int8"])
    out["int8"] = _np(gen(images, ids, mask)).astype(np.int64)

    mesh = make_mesh("cpu", ("data", "model"), (2, 2))
    gen, _ = make_sharded_generate(_mllm(inp["cfg"], inp["sd2"]), mesh, 4, temperature=1.0,
                                   top_k=20)
    draws = [_np(gen(images, ids, mask, torch.Generator().manual_seed(5))).astype(np.int64)
             for _ in range(2)]
    out["sampled"] = draws

    for quant in (False, True):
        mesh = make_mesh("cpu", ("data", "model"), (2, 2))
        gen, _ = make_sharded_paged_generate(_mllm(inp["cfg"], inp["sd"]), mesh, n_new,
                                             page_size=inp["page_size"], quant_kv=quant)
        out[f"paged_{quant}"] = _np(gen(images, ids, mask)).astype(np.int64)

    # the continuous engine across the mesh, through the ordinary batcher on rank 0
    c = inp["continuous"]
    mesh = make_mesh("cpu", ("data", "model"), (2, 2))

    class _Cfg:
        num_vision_tokens = inp["cfg"].num_vision_tokens
        image_size = inp["cfg"].vision.image_size

    loaded = LoadedMLLM(_mllm(c["cfg"], c["sd"]), ConceptTokenizer(), _Cfg(), {},
                        torch.device("cpu"))
    eng = ContinuousEngine(loaded, num_slots=4, max_new_tokens=c["n_new"],
                           max_prompt_len=c["plen"], mesh=mesh)
    out["engine_local_slots"] = eng.local_slots
    if rank == 0:
        import threading

        batcher = ContinuousBatcher(eng)
        results = {}

        def call(i):
            results[i] = batcher.submit(c["images"][i], c["prompts"][i], timeout=120)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(c["prompts"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        batcher.shutdown()
        eng.close()
        out["continuous"] = results
    else:
        eng.follow()
    try:
        ContinuousEngine(loaded, num_slots=3, mesh=make_mesh("cpu", ("data", "model"), (2, 2)))
        out["odd_slots"] = None
    except AssertionError as e:
        out["odd_slots"] = str(e)
    return out


# -- pipeline parallelism ---------------------------------------------------------------


def pipeline_cases(inp, rank):
    from multimodal_concept_learning_tpu_torch.models.lm import CausalLM
    from multimodal_concept_learning_tpu_torch.parallel.pipeline import (
        make_pipelined_hidden_states,
        make_pipelined_mllm_loss,
        shard_pipeline_params,
    )

    out = {}
    lm_in = inp["lm"]
    for stages, micro in ((2, 4), (4, 2)):
        mesh = make_mesh("cpu", ("data", "pipe"), (4 // stages, stages))
        lm = CausalLM(lm_in["cfg"])
        lm.load_state_dict(lm_in["sd"])
        shard_pipeline_params(lm, mesh)
        fn = make_pipelined_hidden_states(lm, mesh, micro)
        with torch.no_grad():
            hidden = fn(torch.as_tensor(lm_in["embeds"]), torch.as_tensor(lm_in["mask"]))
        out[f"forward_{stages}_{micro}"] = _np(hidden)
        out[f"local_layers_{stages}"] = len(lm.model.layers)

    # gradients of mean(h^2) through 2 stages x 4 microbatches
    g_in = inp["lm_grad"]
    mesh = make_mesh("cpu", ("data", "pipe"), (2, 2))
    lm = CausalLM(g_in["cfg"])
    lm.load_state_dict(g_in["sd"])
    shard_pipeline_params(lm, mesh)
    col.reset_counts()
    fn = make_pipelined_hidden_states(lm, mesh, 4)
    embeds = torch.as_tensor(g_in["embeds"])
    loss = (fn(embeds, torch.as_tensor(g_in["mask"])).float() ** 2).mean()
    loss.backward()
    first = lm._mcl_pipe["first"]
    grads = {}
    for name, p in lm.named_parameters():
        if ".layers." in name:
            j = int(name.split(".layers.")[1].split(".")[0])
            name = name.replace(f".layers.{j}.", f".layers.{first + j}.", 1)
        if p.grad is not None:  # the embedding is not on this path
            grads[name] = _np(p.grad)
    out["grad_loss"] = float(loss)
    out["grads"] = grads
    out["grad_counts"] = dict(col.COUNTS)

    # the MLLM loss and its gradients, 2 stages x 2 microbatches
    mm = inp["mllm"]
    mesh = make_mesh("cpu", ("data", "pipe"), (2, 2))
    model = _mllm(mm["cfg"], mm["sd"])
    model.train()
    shard_pipeline_params(model, mesh)
    loss_fn = make_pipelined_mllm_loss(model, mesh, num_microbatches=2)
    loss = loss_fn({k: torch.as_tensor(v) for k, v in mm["batch"].items()})
    loss.backward()
    first = model.language_model._mcl_pipe["first"]
    grads = {}
    for name, p in model.named_parameters():
        if ".layers." in name:
            j = int(name.split(".layers.")[1].split(".")[0])
            name = name.replace(f".layers.{j}.", f".layers.{first + j}.", 1)
        grads[name] = _np(p.grad)
    out["mllm_loss"] = float(loss)
    out["mllm_grads"] = grads
    return out


# -- sequence parallelism -------------------------------------------------------------------


def ring_cases(inp, rank):
    from multimodal_concept_learning_tpu_torch.parallel.ring_attention import (
        make_ring_attention,
        shard_seq,
    )

    out = {}
    for key, case in inp["cases"].items():
        n = case["shards"]
        mesh = make_mesh("cpu", ("data", "seq"), (4 // n, n))
        ring = make_ring_attention(mesh)
        q, k, v = (torch.as_tensor(case[x]).requires_grad_() for x in ("q", "k", "v"))
        bias = torch.as_tensor(case["bias"])
        ql, kl, vl = (shard_seq(x, mesh) for x in (q, k, v))
        bl = shard_seq(bias, mesh, dim=2)
        o = ring(ql, kl, vl, bl, scale=case.get("scale"))
        full = col.all_gather(o.detach(), col.mesh_group(mesh, "seq"), 1)
        res = {"out": _np(full)}
        if case.get("grad"):
            t = full.numel()
            weights = torch.arange(t, dtype=torch.float32).reshape(full.shape)
            w_local = shard_seq(weights, mesh)
            (o * w_local).sum().div(t).backward()
            # each rank holds its blocks' gradients of q, and of k/v summed over the ring
            grads = {}
            for name, x in (("q", q), ("k", k), ("v", v)):
                grads[name] = _np(multihost.all_reduce_sum(x.grad, col.mesh_group(mesh, "seq")))
            res["grads"] = grads
        out[key] = res
    return out


SUITES = {"tp": tp_cases, "serving": serving_cases, "pipeline": pipeline_cases,
          "ring": ring_cases}


def main():
    suite, rank, world, port, workdir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                         sys.argv[4], sys.argv[5])
    started = time.time()
    torch.set_num_threads(1)
    # a rank stuck in a collective prints every thread's stack and exits
    faulthandler.dump_traceback_later(float(os.environ.get("MCL_MESH_TIMEOUT", "400")),
                                      exit=True)
    path = os.path.join(workdir, "inputs.pt")
    deadline = time.time() + 180
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.05)
    inputs = torch.load(path, weights_only=False)
    out = {}
    t0 = time.time()
    try:
        assert multihost.init_distributed("cpu", init_method=f"tcp://localhost:{port}",
                                          world_size=world, rank=rank, timeout_s=120)
        out["seconds_waiting"] = t0 - started
        out.update(SUITES[suite](inputs, rank))
        out["seconds"] = time.time() - t0
    except Exception:  # noqa: BLE001 - reported to the test
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()
    sys.exit(1 if "error" in out else 0)


if __name__ == "__main__":
    main()
