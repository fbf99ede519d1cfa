"""One rank of ``tests/test_torch_distributed.py``'s two-process Gloo group.

    python tests/_torch_dp_worker.py RANK WORLD PORT WORKDIR

Waits for ``WORKDIR/inputs.pt`` (weights, global batches and CLI configs
that the test writes while the ranks start), joins the group over
``tcp://localhost:PORT``, runs every case on its stripe of each global
batch, and writes ``WORKDIR/rank{R}.pt`` (losses, parameters, flags) for
the test to hold against JAX's single process and against the other rank.
Imports no JAX.
"""

import contextlib
import io
import json
import os
import signal
import sys
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stripe(batch, rank, world):
    """Rank ``rank``'s rows of a global numpy batch (non-batch leaves whole)."""
    b = len(batch["valid"])
    rows = slice(rank * b // world, (rank + 1) * b // world)
    return {k: (v[rows] if np.ndim(v) and len(v) == b else v) for k, v in batch.items()}


def _params(model):
    return {n: p.detach().float().clone() for n, p in model.named_parameters()}


def step_cases(inputs, rank, world):
    """The three trainers' steps on this rank's stripes."""
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPModel
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask
    from multimodal_concept_learning_tpu_torch.models.vit import ViTForImageClassification
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel import train_step as ts

    out = {}
    # the MLLM with MoE: two micro-steps of one accumulated update, then eval
    m = inputs["mllm"]
    model = build_mllm(m["cfg"], m["sd"], "cpu")
    trainable_mask(model, m["setting"])
    opt = build_optimizer(model, m["lr"], **m["hp"])
    state = ts.TrainState(model=model, optimizer=opt)
    step = ts.make_mllm_train_step(model)
    out["mllm_losses"] = []
    for batch in m["batches"]:
        state, metrics = step(state, to_device(_stripe(batch, rank, world), "cpu"))
        out["mllm_losses"].append(metrics["loss"].item())
    out["mllm_params"] = _params(model)
    ev = ts.make_mllm_eval_step(model)(
        model, to_device(_stripe(m["eval_batch"], rank, world), "cpu"))
    out["mllm_eval_loss"] = ev["loss"].item()

    # the vision classifier at dropout 0: one update, then eval on a padded batch
    v = inputs["vision"]
    model = ViTForImageClassification(v["cfg"])
    model.load_state_dict(v["sd"], strict=True)
    opt = build_optimizer(model, v["lr"], **v["hp"])
    state = ts.TrainState(model=model, optimizer=opt)
    step = ts.make_classifier_train_step(model, torch.Generator().manual_seed(rank),
                                         v["label_smoothing"])
    state, metrics = step(state, to_device(_stripe(v["batch"], rank, world), "cpu"))
    out["vision_loss"], out["vision_correct"] = metrics["loss"].item(), int(metrics["correct"])
    out["vision_params"] = _params(model)
    ev = ts.make_classifier_eval_step(model, v["label_smoothing"])(
        model, to_device(_stripe(v["eval_batch"], rank, world), "cpu"))
    out["vision_eval"] = (ev["loss"].item(), int(ev["correct"]), int(ev["count"]))

    # CLIP: one update over the gathered [B, B] logits
    c = inputs["clip"]
    model = CLIPModel(c["cfg"])
    model.load_state_dict(c["sd"], strict=True)
    opt = build_optimizer(model, c["lr"], **c["hp"])
    state = ts.TrainState(model=model, optimizer=opt)
    state, metrics = ts.make_clip_train_step(model)(
        state, to_device(_stripe(c["batch"], rank, world), "cpu"))
    out["clip_loss"] = metrics["loss"].item()
    out["clip_params"] = _params(model)
    return out


def api_cases(rank, world):
    from multimodal_concept_learning_tpu_torch.parallel import mesh, multihost
    from multimodal_concept_learning_tpu_torch.train.common import (
        mesh_for_batch,
        process_local_loader_args,
    )

    out = {}
    dm = mesh.make_mesh()
    out["mesh"] = (tuple(dm.mesh.tolist()), dm.mesh_dim_names)
    out["loader_args"] = process_local_loader_args(8)
    try:
        mesh_for_batch(3)
        out["odd_batch"] = "accepted"
    except ValueError as e:
        out["odd_batch"] = str(e)
    batch = {"images_u8": np.zeros((2, 4, 4, 3), np.uint8), "valid": np.ones(2, bool),
             "norm_mean": np.ones(3, np.float32)}
    out["same_leaves"] = multihost.global_batch_from_local(batch, "cpu")["images_u8"].shape
    batch["norm_mean"] = batch["norm_mean"] + rank
    try:
        multihost.global_batch_from_local(batch, "cpu")
        out["differing_leaves"] = "accepted"
    except ValueError as e:
        out["differing_leaves"] = str(e)
    out["any_rank"] = (multihost.any_rank(rank == 1), multihost.any_rank(False))
    out["broadcast"] = multihost.broadcast(f"from rank {rank}")
    return out


def _cli(trainer, path):
    from multimodal_concept_learning_tpu_torch.train import (
        contrastive_training,
        multimodal_training,
        vision_training,
    )

    mod = {"vision": vision_training, "mllm": multimodal_training,
           "clip": contrastive_training}[trainer]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mod.main(["--config_path", path, "--device", "cpu"])
    return res, buf.getvalue()


def _final_state(res):
    state = res["state"] if isinstance(res, dict) else res[0]
    return state.step, _params(state.model)


def multihost_barrier():
    from multimodal_concept_learning_tpu_torch.parallel import multihost

    multihost.barrier()


def cli_cases(inputs, rank):
    """Each CLI under the group: only rank 0 writes (each rank its own
    results dir); then the MLLM CLI with resume, rank 1 SIGTERMs itself
    after its second step, and the rerun resumes."""
    import multimodal_concept_learning_tpu_torch.train.multimodal_training as mt

    out = {}
    for trainer in ("mllm", "vision", "clip"):
        res, log = _cli(trainer, inputs["cli"][trainer][rank])
        out[f"cli_{trainer}"] = (*_final_state(res), log)

    steps_taken = []
    make_step = mt.make_mllm_train_step

    def counting(model):
        inner = make_step(model)

        def step(state, batch):
            state, metrics = inner(state, batch)
            steps_taken.append(state.step)
            if rank == 1 and len(steps_taken) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics

        return step

    mt.make_mllm_train_step = counting
    try:
        res, log = _cli("mllm", inputs["cli"]["resume"])
    finally:
        mt.make_mllm_train_step = make_step
    out["preempted"] = (res, len(steps_taken), log)
    meta = os.path.join(os.path.dirname(inputs["cli"]["resume"]), "resume", "resume",
                        "loop_meta.json")
    multihost_barrier()
    with open(meta) as f:
        out["preempted_meta"] = json.load(f)
    res, log = _cli("mllm", inputs["cli"]["resume"])
    out["resumed"] = (*_final_state(res), log)
    return out


def main():
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(2)
    from multimodal_concept_learning_tpu_torch.parallel import multihost

    from multimodal_concept_learning_tpu_torch.train import (  # noqa: F401 - imported early
        contrastive_training,
        multimodal_training,
        vision_training,
    )

    path = os.path.join(workdir, "inputs.pt")
    deadline = time.time() + 180
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.05)
    inputs = torch.load(path, weights_only=False)
    out = {}
    try:
        assert multihost.init_distributed("cpu", init_method=f"tcp://localhost:{port}",
                                          world_size=world, rank=rank, timeout_s=120)
        out.update(step_cases(inputs, rank, world))
        out.update(api_cases(rank, world))
        out.update(cli_cases(inputs, rank))
    except Exception:  # noqa: BLE001 - reported to the test
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    multihost.shutdown()
    sys.exit(1 if "error" in out else 0)


if __name__ == "__main__":
    main()
