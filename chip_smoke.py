"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, on a line of their own;
2. build: compile the port's CUDA kernels from ``csrc/`` (timed);
3. kernels: each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the serving and training paths' shapes (max abs
   error, and kernel vs plain time from CUDA events);
4. parity: float32 MLLM at full width and reduced depth, ``paged_generate``
   on the card (through both kernels) must give exactly the greedy tokens
   of the same weights on the CPU plain path;
5. slice: a seeded random-init results dir of the full ``12_colors_3k``
   configuration, served by the port's paged server (``make_server``):
   16 requests from 16 threads, ``/healthz`` and ``/metrics`` over HTTP,
   launch counts of both kernels;
6. training parity: float32 MLLM at full width and reduced depth, three
   micro-steps with accumulation 2 on the card and on the CPU plain path:
   the same losses and trained tensors, frozen tensors bitwise unchanged;
7. training slice: the port's trainer CLI (``multimodal_training.main``)
   trains the full ``12_colors_3k`` model (seeded random init) for one epoch
   on a small generated 12-color dataset; launch counts of the K1 forward,
   dQ and dK/dV kernels per micro-step, finite losses, trained tensors
   moved, frozen tensors bitwise those of ``initial_model.pt``, the full
   results layout, and micro-steps/s and samples/s.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max abs error vs the plain version, unit-scale inputs


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(out, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    return out


def phase_build() -> None:
    from multimodal_concept_learning_tpu_torch.ops import _build

    info = _build.build()
    _build.kernels()
    print(f"[build] {info['path']} in {info['seconds']:.1f} s", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] ptxas: {line.strip()}", flush=True)


def _flash_cases(torch, gen, dev):
    """(name, q, k, v, kwargs) at the serving path's K1 shapes."""

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    b = 8
    lens = torch.randint(197, 262, (b,), generator=gen, device=dev).to(torch.int32)
    lens[0] = 261
    lm = dict(scale=1 / 16, kv_lens=lens, causal=True)
    return [
        ("vit [8,197,12,64]", randn(b, 197, 12, 64), randn(b, 197, 12, 64),
         randn(b, 197, 12, 64), {}),
        ("lm [8,261,4/1,256] causal+kv_lens", randn(b, 261, 4, 256), randn(b, 261, 1, 256),
         randn(b, 261, 1, 256), lm),
        ("lm window 64", randn(b, 261, 4, 256), randn(b, 261, 1, 256),
         randn(b, 261, 1, 256), dict(lm, window=64)),
        ("lm + bias [8,1,261,261]", randn(b, 261, 4, 256), randn(b, 261, 1, 256),
         randn(b, 261, 1, 256), dict(lm, bias=randn(b, 1, 261, 261))),
        ("d 128 [2,100,8/8,128] causal", randn(2, 100, 8, 128), randn(2, 100, 8, 128),
         randn(2, 100, 8, 128), dict(causal=True)),
    ]


LM_TRAIN_T = 197 + 24  # vision tokens + the collator's pad_to for 12_colors_3k


def _flash_bwd_cases(torch, gen, dev):
    """(name, q, k, v, kwargs, bias needs grad) at the training path's K1
    shapes: the LM at batch 2 (4q/1kv heads of 256, causal + kv_lens, scale
    1/16), with a window, with a float32 bias that needs a gradient, and
    the ViT (12 heads of 64, no mask); then one case at head dim 128."""

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    t = LM_TRAIN_T
    lens = torch.tensor([t, t - 9], dtype=torch.int32, device=dev)
    lm = dict(scale=1 / 16, kv_lens=lens, causal=True)
    lm_qkv = lambda: (randn(2, t, 4, 256), randn(2, t, 1, 256), randn(2, t, 1, 256))  # noqa: E731
    return [
        (f"lm [2,{t},4/1,256] causal+kv_lens", *lm_qkv(), lm, False),
        ("lm window 64", *lm_qkv(), dict(lm, window=64), False),
        (f"lm + bias [2,1,{t},{t}] (dbias)", *lm_qkv(), dict(lm, bias=randn(2, 1, t, t)), True),
        ("vit [2,197,12,64]", randn(2, 197, 12, 64), randn(2, 197, 12, 64),
         randn(2, 197, 12, 64), {}, False),
        # the kernels' third head dim, group 4 over 2 kv heads, a per-head bias
        ("d 128 [2,100,8/2,128] causal + window 37 + bias [2,8,100,100]",
         randn(2, 100, 8, 128), randn(2, 100, 2, 128), randn(2, 100, 2, 128),
         dict(causal=True, window=37, bias=randn(2, 8, 100, 100)), True),
    ]


def _phase_flash_bwd(torch, fa, gen, dev, report: dict) -> None:
    """Each backward kernel against the plain backward on the same saved
    (q, k, v, o, lse, dO): float32 <= 1e-4 abs, bf16 <= 2e-2 of the
    reference's max |value|."""
    kdq = report.setdefault("flash_attention_bwd_dq", {"max_abs_err": 0.0})
    kdkv = report.setdefault("flash_attention_bwd_dkv", {"max_abs_err": 0.0})
    for name, q, k, v, kw, bias_grad in _flash_bwd_cases(torch, gen, dev):
        do = torch.randn(q.shape, generator=gen, device=dev)
        mask = {key: kw[key] for key in ("kv_lens", "causal", "window") if key in kw}
        scale = kw.get("scale", q.shape[-1] ** -0.5)
        bias = kw.get("bias")
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd, dod = (x.to(dtype) for x in (q, k, v, do))
            o, lse = fa._launch(qd, kd, vd, bias, scale, mask.get("kv_lens"),
                                mask.get("causal", False), mask.get("window"), with_lse=True)
            ref = fa.flash_attention_backward_reference(
                qd.float(), kd.float(), vd.float(), o.float(), lse, dod.float(), bias,
                scale=scale, **mask)

            def dq_call():
                return fa.flash_attention_bwd_dq(qd, kd, vd, o, lse, dod, bias, scale=scale,
                                                 need_ds=bias_grad, **mask)

            dq, delta, ds = dq_call()

            def dkv_call():
                return fa.flash_attention_bwd_dkv(qd, kd, vd, dod, lse, delta, bias,
                                                  scale=scale, **mask)

            dk, dv = dkv_call()
            torch.cuda.synchronize()
            tag = str(dtype).replace("torch.", "")
            pairs = {"dq": (dq, ref[0]), "dk": (dk, ref[1]), "dv": (dv, ref[2])}
            if bias_grad:
                pairs["dbias"] = (fa._unbroadcast(ds, bias), ref[3])
            errs, ok = {}, True
            for g, (got, want) in pairs.items():
                errs[g] = (got.float() - want.float()).abs().max().item()
                limit = TOL[tag] if dtype is torch.float32 else TOL[tag] * want.abs().max().item()
                ok = ok and errs[g] <= limit
            dq_ms = cuda_time_ms(dq_call)
            dkv_ms = cuda_time_ms(dkv_call)
            plain_ms = cuda_time_ms(lambda: fa.flash_attention_backward_reference(
                qd, kd, vd, o, lse, dod, bias, scale=scale, **mask))
            print(f"[kernels] K1 bwd {name} {tag}: max_abs_err "
                  + " ".join(f"{g} {e:.3e}" for g, e in errs.items())
                  + f"; dq kernel {dq_ms:.4f} ms, dkv kernel {dkv_ms:.4f} ms, "
                  f"plain backward {plain_ms:.4f} ms", flush=True)
            if not ok:
                fail(f"K1 bwd {name} {tag}: errors {errs}")
            kdq["max_abs_err"] = max(kdq["max_abs_err"], errs["dq"], errs.get("dbias", 0.0))
            kdkv["max_abs_err"] = max(kdkv["max_abs_err"], errs["dk"], errs["dv"])
            if name.startswith("lm [") and dtype is torch.bfloat16:
                kdq.update(ms=dq_ms, plain_ms=plain_ms)
                kdkv.update(ms=dkv_ms, plain_ms=plain_ms)


def _paged_case(torch, gen, dev, hq, hk, d, ps, np_, lens):
    """(q, pool_k, pool_v, page_table, lens): rows own shuffled pages."""
    b = len(lens)
    pages = 1 + b * np_
    perm = torch.randperm(pages - 1, generator=gen, device=dev)[: b * np_] + 1
    pt = perm.reshape(b, np_).to(torch.int32)
    q = torch.randn(b, 1, hq, d, generator=gen, device=dev)
    pk = torch.randn(pages, hk, ps, d, generator=gen, device=dev)
    pv = torch.randn(pages, hk, ps, d, generator=gen, device=dev)
    return q, pk, pv, pt, torch.tensor(lens, dtype=torch.int32, device=dev)


def _paged_cases(torch, gen, dev):
    """(name, q, pool_k, pool_v, page_table, lens, window): gemma3-1b shapes
    (hk 1, group 4, d 256, page 16), 8 ragged rows incl. one of length 0,
    then one case at the kernel's other head dim, group and page size."""
    gemma = _paged_case(torch, gen, dev, 4, 1, 256, 16, 40, [0, 1, 15, 16, 17, 261, 530, 640])
    other = _paged_case(torch, gen, dev, 4, 2, 128, 8, 40, [0, 7, 33, 300])
    return ([(f"gemma3 decode window {w}", *gemma, w) for w in (-1, 512, 20)]
            + [("hk 2, group 2, d 128, page 8, window 97", *other, 97)])


def phase_kernels(report: dict) -> None:
    import torch

    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_kernel as pk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = report.setdefault("flash_attention_fwd", {"max_abs_err": 0.0})
    k3 = report.setdefault("paged_decode_attention", {"max_abs_err": 0.0})
    with torch.no_grad():
        for name, q, k, v, kw in _flash_cases(torch, gen, dev):
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = (t.to(dtype) for t in (q, k, v))
                out = fa.flash_attention(qd, kd, vd, **kw)
                # the plain version in float32 on the same (dtype-rounded) inputs
                ref = fa.flash_attention_reference(qd.float(), kd.float(), vd.float(), **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ms = cuda_time_ms(lambda: fa.flash_attention(qd, kd, vd, **kw))
                plain_ms = cuda_time_ms(lambda: fa.flash_attention_reference(qd, kd, vd, **kw))
                tag = str(dtype).replace("torch.", "")
                print(f"[kernels] K1 {name} {tag}: max_abs_err {err:.3e} "
                      f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
                if not err <= TOL[tag]:
                    fail(f"K1 {name} {tag}: max abs err {err} > {TOL[tag]}")
                k1["max_abs_err"] = max(k1["max_abs_err"], err)
                if name.startswith("lm [") and dtype is torch.bfloat16:
                    k1.update(ms=ms, plain_ms=plain_ms)
        for name, q, pool_k, pool_v, pt, lens, w in _paged_cases(torch, gen, dev):
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = (t.to(dtype) for t in (q, pool_k, pool_v))
                args = (qd, kd, vd, pt, lens)
                out = pk.paged_decode_attention(*args, scale=1 / 16, window=w)
                ref = pk.paged_decode_attention_reference(
                    qd.float(), kd.float(), vd.float(), pt, lens, scale=1 / 16, window=w)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                zero_row = out[0].abs().max().item()
                ms = cuda_time_ms(lambda: pk.paged_decode_attention(*args, scale=1 / 16, window=w))
                plain_ms = cuda_time_ms(
                    lambda: pk.paged_decode_attention_reference(*args, scale=1 / 16, window=w))
                tag = str(dtype).replace("torch.", "")
                print(f"[kernels] K3 {name} {tag}: max_abs_err {err:.3e} len-0 row "
                      f"{zero_row:.1e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
                if not (err <= TOL[tag] and zero_row == 0.0):
                    fail(f"K3 {name} {tag}: max abs err {err}, len-0 row max {zero_row}")
                k3["max_abs_err"] = max(k3["max_abs_err"], err)
                if w == 512 and dtype is torch.bfloat16:
                    k3.update(ms=ms, plain_ms=plain_ms)
        _phase_flash_bwd(torch, fa, gen, dev, report)


def _circle(rgb, size: int = 224) -> np.ndarray:
    """[3, size, size] float image in [0, 1]: a colored circle on white."""
    yy, xx = np.mgrid[:size, :size]
    inside = (xx - size // 2) ** 2 + (yy - size // 2) ** 2 <= (size // 3) ** 2
    img = np.ones((3, size, size), np.float32)
    img[:, inside] = np.asarray(rgb, np.float32)[:, None] / 255.0
    return img


def phase_parity() -> None:
    """Full widths, 2 ViT + 2 LM layers (one sliding, one global), float32:
    greedy paged_generate on the card == on the CPU plain path."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import (
        build_mllm,
        init_random_weights_,
    )
    from multimodal_concept_learning_tpu_torch.models.mllm import (
        MLLM,
        MLLMConfig,
        paged_generate,
    )
    from multimodal_concept_learning_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel import (
        paged_decode_attention,
    )

    base = MLLMConfig.create(vocab_size=1148, dtype=torch.float32)  # 1142 + 6 OOD tokens
    rng = np.random.default_rng(SEED)
    lens = [64, 40, 17, 5]  # text tokens per row; T = 197 + 64 = 261
    t = 197 + max(lens)
    ids = rng.integers(4, 1148, size=(len(lens), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        mask[i, : 197 + n] = 1
    ids[mask == 0] = 0
    images = np.stack([_circle(c) for c in ([255, 0, 0], [0, 128, 255], [40, 200, 40],
                                            [250, 250, 0])])
    inputs = [torch.from_numpy(x) for x in (images, ids, mask)]
    for window in (512, 64):
        cfg = dataclasses.replace(
            base, vision=dataclasses.replace(base.vision, num_hidden_layers=2),
            lm=dataclasses.replace(base.lm, num_layers=2, sliding_window=window,
                                   sliding_window_pattern=2))
        gen = torch.Generator().manual_seed(SEED)
        sd = init_random_weights_(MLLM(cfg), gen).state_dict()
        before = (flash_attention.launches, paged_decode_attention.launches)
        on_card = paged_generate(build_mllm(cfg, sd, "cuda"), *inputs, max_new_tokens=8,
                                 page_size=16).cpu().numpy()
        launched = (flash_attention.launches - before[0],
                    paged_decode_attention.launches - before[1])
        on_cpu = paged_generate(build_mllm(cfg, sd, "cpu"), *inputs, max_new_tokens=8,
                                page_size=16).numpy()
        same = bool((on_card == on_cpu).all())
        print(f"[parity] window {window}: cuda tokens == cpu tokens: {same} "
              f"(kernel launches K1 {launched[0]}, K3 {launched[1]}); cuda {on_card.tolist()}",
              flush=True)
        if not same or min(launched) == 0:
            fail(f"parity at window {window}: cpu {on_cpu.tolist()}, launches {launched}")


TRAINING_CONFIG = {  # experiments/multimodal/color/12_colors_3k.yaml (served fields)
    "prompt_template": "Is the color of the circle {class_name}?",
    "dataset_name": "color_multimodal", "vision_model_name": "vit-b-16",
    "language_model_name": "google/gemma-3-1b-it", "vision_path": None,
    "num_vision_tokens": 197, "num_labels": 12,
    "trainable_params_setting": "language_embed_only", "torch_dtype": "bfloat16",
    "seed": 42, "image_size": 224, "train_transforms": ["ToTensor"],
    "val_transforms": ["ToTensor"], "run_name": "mllm_12_colors_3k_ood",
}
MAPPING = os.path.join(REPO, "experiments/multimodal/color/12_colors_3k_labels_mapping.json")


def _write_results_dir(root: str) -> None:
    """A seeded random-init results dir of the full 12_colors_3k model."""
    import shutil

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import (
        init_random_weights_,
        save_results_dir,
    )
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.serve.loader import (
        build_tokenizer,
        model_config,
        training_config,
    )

    mapping = os.path.join(root, "labels_mapping.json")
    shutil.copy(MAPPING, mapping)
    cfg_dict = dict(TRAINING_CONFIG, labels_mapping_path=os.path.abspath(mapping),
                    results_dir=os.path.abspath(root))
    config = training_config(cfg_dict)
    tokenizer, _ = build_tokenizer(config)
    cfg = model_config(config, len(tokenizer), torch.float32)
    with torch.device("cuda"):
        model = MLLM(cfg)
    init_random_weights_(model, torch.Generator(device="cuda").manual_seed(SEED))
    save_results_dir(root, model, tokenizer, cfg_dict)
    n = sum(p.numel() for p in model.parameters())
    print(f"[slice] random-init results dir: vocab {len(tokenizer)}, {n} parameters", flush=True)


def phase_slice(report: dict, root: str) -> None:
    import http.client
    import threading

    import torch

    from multimodal_concept_learning_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel import (
        paged_decode_attention,
    )
    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    t0 = time.perf_counter()
    _write_results_dir(root)
    torch.cuda.empty_cache()
    httpd, batcher = make_server(root, port=0, paged=True, batch_size=8, max_new_tokens=8,
                                 page_size=16)
    print(f"[slice] results dir written and served in {time.perf_counter() - t0:.1f} s",
          flush=True)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    with open(MAPPING) as f:
        mapping = list(json.load(f).items())  # "r255g128b0" -> "<ood 1>"
    requests = []
    for i in range(16):
        key, name = mapping[i % len(mapping)]
        rgb = [int(x) for x in re.findall(r"\d+", key)]
        requests.append((_circle(rgb), f"Is the color of the circle {name}?"))
    try:
        flash_attention.launches = 0
        paged_decode_attention.launches = 0
        batcher.submit(*requests[0])  # first request: cuBLAS/allocator warm-up
        results, tokens, latency = [None] * 16, [0] * 16, [0.0] * 16

        def run(i):
            def count(_tok, i=i):
                tokens[i] += 1
            t = time.perf_counter()
            results[i] = batcher.submit(*requests[i], on_token=count)
            latency[i] = time.perf_counter() - t

        threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": flash_attention.launches,
                    "paged_decode_attention": paged_decode_attention.launches}
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.request("GET", "/metrics")
        metrics = json.loads(conn.getresponse().read())
        conn.close()
        finite = all(bool(torch.isfinite(p[kv]).all())
                     for p in batcher.engine.pools for kv in ("k", "v"))
    finally:
        httpd.shutdown()
        batcher.shutdown()
        server.join(timeout=30)
    print(f"[slice] 16 requests from 16 threads in {wall:.3f} s: {16 / wall:.3f} requests/s, "
          f"{sum(tokens) / wall:.1f} generated tokens/s ({sum(tokens)} tokens); "
          f"p50 latency {1e3 * float(np.median(latency)):.1f} ms, "
          f"max {1e3 * max(latency):.1f} ms", flush=True)
    print(f"[slice] healthz {health}; metrics {metrics}", flush=True)
    print(f"[slice] answers {results[:4]} ...; kernel launches {launches}", flush=True)
    if not all(isinstance(r, str) for r in results):
        fail("not every request was answered")
    if not (health.get("ok") and metrics.get("completed") == 17 and finite):
        fail(f"server state: healthz {health}, metrics {metrics}, finite pools {finite}")
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was never launched by the serving path")
        report[name]["launches"] = n


def _train_batch(tokenizer, labels_mapping, seed: int, b: int = 2):
    """A collated 224px training batch of the 12_colors_3k prompts (numpy)."""
    from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator

    names = sorted(labels_mapping)
    collator = MultimodalCollator(tokenizer, 197, TRAINING_CONFIG["prompt_template"], names,
                                  labels_mapping, seed=seed)
    samples = []
    for i in range(b):
        key = names[(seed * b + i) % len(names)]
        samples.append((_circle([int(x) for x in re.findall(r"\d+", key)]), key))
    return collator(samples)


def phase_train_parity() -> None:
    """Full widths, 2 ViT + 2 LM layers (one sliding, one global), float32,
    language_embed_only: three micro-steps with accumulation 2 on the card
    (K1 forward, dQ and dK/dV kernels) and on the CPU (plain versions) give
    the same losses and trained tensors; frozen tensors stay bitwise."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.mllm import (
        MLLM,
        MLLMConfig,
        copy_init_ood_rows,
        trainable_mask,
    )
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )
    from multimodal_concept_learning_tpu_torch.serve.loader import build_tokenizer, training_config

    with open(MAPPING) as f:
        labels_mapping = json.load(f)
    tokenizer, _ = build_tokenizer(training_config(dict(TRAINING_CONFIG,
                                                        labels_mapping_path=MAPPING)))
    base = MLLMConfig.create(vocab_size=len(tokenizer), dtype=torch.float32)
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_hidden_layers=2),
        lm=dataclasses.replace(base.lm, num_layers=2, sliding_window=64,
                               sliding_window_pattern=2))
    model0 = init_random_weights_(MLLM(cfg), torch.Generator().manual_seed(SEED))
    copy_init_ood_rows(model0, 6)
    sd = {k: v.clone() for k, v in model0.state_dict().items()}
    batches = [_train_batch(tokenizer, labels_mapping, seed=i) for i in range(3)]
    runs = {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            model = MLLM(cfg)
        model.load_state_dict(sd, strict=True)
        mask = trainable_mask(model, "language_embed_only")
        opt = build_optimizer(model, 5e-4, weight_decay=1e-4, max_grad_norm=1.0,
                              accumulation_steps=2)
        state, step = TrainState(model=model, optimizer=opt), make_mllm_train_step(model)
        before = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkv.launches)
        losses = []
        for batch in batches:
            state, m = step(state, to_device(batch, dev))
            losses.append(float(m["loss"]))
        launched = tuple(n - b for n, b in zip((fa.flash_attention.launches,
                                               fa.flash_attention_bwd_dq.launches,
                                               fa.flash_attention_bwd_dkv.launches), before))
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     launched, mask)
    (cl, csd, claunch, mask), (pl, psd, plaunch, _) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, pl))
    trained = [n for n, t in mask.items() if t]
    # Adam's first update is ~lr * g / |g| per element, so an element whose
    # gradient nearly cancels can flip between two summation orders: hold
    # each trained tensor to 1e-4 relative in norm, and report the largest
    # element difference in units of the learning rate
    param_err = max(((csd[n] - psd[n]).norm() / psd[n].norm()).item() for n in trained)
    worst = max((csd[n] - psd[n]).abs().max().item() for n in trained) / 5e-4
    moved = all(not torch.equal(csd[n], sd[n]) for n in trained)
    frozen_same = all(torch.equal(csd[n], sd[n]) and torch.equal(psd[n], sd[n])
                      for n, t in mask.items() if not t)
    print(f"[train-parity] losses cuda {cl} cpu {pl}: max rel err {loss_err:.2e}; trained "
          f"tensors {trained}: max norm-relative err {param_err:.2e} (largest element "
          f"difference {worst:.3f} lr), moved {moved}; frozen bitwise "
          f"unchanged {frozen_same}; kernel launches (fwd, dq, dkv) cuda {claunch} "
          f"cpu {plaunch}", flush=True)
    if not (loss_err <= 1e-4 and param_err <= 1e-4 and moved and frozen_same):
        fail("training parity CUDA vs CPU")
    if min(claunch) == 0 or max(plaunch) != 0:
        fail(f"training parity launches: cuda {claunch}, cpu {plaunch}")


def _write_train_config(root: str, data_dir: str) -> str:
    """experiments/multimodal/color/12_colors_3k.yaml with the paths under
    ``root``, epochs 1 and 2 loader workers, as a YAML file."""
    from multimodal_concept_learning_tpu_torch import miniyaml

    with open(os.path.join(REPO, "experiments/multimodal/color/12_colors_3k.yaml")) as f:
        text = f.read()
    overrides = {
        "mapping_path": os.path.join(data_dir, "train_mapping.csv"),
        "image_root": data_dir,
        "labels_mapping_path": MAPPING,
        "results_dir": os.path.join(root, "results"),
        "epochs": "1",
        "num_workers": "2",
    }
    lines = []
    for line in text.splitlines():
        key = line.split(":", 1)[0]
        lines.append(f"{key}: {overrides[key]}" if key in overrides and not line.startswith(" ")
                     else line)
    path = os.path.join(root, "12_colors_3k.yaml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(path) as f:
        parsed = miniyaml.safe_load(f)
    assert parsed["epochs"] == 1 and parsed["batch_size"] == 2 and parsed["image_root"] == data_dir
    return path


def phase_train_slice(report: dict, root: str, images_per_color: int = 8) -> None:
    """The port's trainer CLI on the full 12_colors_3k model, one epoch."""
    import csv

    import torch

    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.checkpoint import changed_frozen, load_state_dict
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig,
        generate_color_dataset,
    )
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import main as train_main

    t0 = time.perf_counter()
    with open(os.path.join(REPO, "experiments/datasets/color/12_colors_3k.yaml")) as f:
        ds = dict(miniyaml.safe_load(f), n_images_per_color=images_per_color,
                  data_dir=os.path.join(root, "data"))
    data_dir = generate_color_dataset(ColorDatasetConfig.from_params(ds), verbose=False)
    sizes = {}
    for split in ("train", "val", "test"):
        with open(os.path.join(data_dir, f"{split}_mapping.csv")) as f:
            sizes[split] = sum(1 for _ in csv.DictReader(f))
    cfg_path = _write_train_config(root, data_dir)
    print(f"[train] {images_per_color} images per color generated ({sizes}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.empty_cache()
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    state, test_metrics, logged = train_main(["--config_path", cfg_path, "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in zip(
        ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"), counters)}

    micro = sizes["train"] // 2  # batch 2, drop_last
    evals = -(-sizes["val"] // 2) + -(-sizes["test"] // 2)
    expected = {"flash_attention_fwd": 38 * (micro + evals),  # 12 ViT + 26 LM layers
                "flash_attention_bwd_dq": 26 * micro, "flash_attention_bwd_dkv": 26 * micro}
    epoch = logged[0] if logged else {}
    models = os.path.join(root, "results", "models")
    layout = ["initial_model.pt", "best_model.pt", "epoch_0_model.pt", "training_config.json",
              "tokenizer"]
    missing = [n for n in layout if not os.path.exists(os.path.join(models, n))]
    init_sd = load_state_dict(os.path.join(models, "initial_model.pt"))
    best_sd = load_state_dict(os.path.join(models, "best_model.pt"))
    trained = ("language_model.model.embed_tokens.weight", "projector.weight", "projector.bias")
    moved = all(not torch.equal(init_sd[n], best_sd[n]) for n in trained)
    # the checkpoints' layout: frozen leaves bitwise those of initial_model.pt
    frozen_same = all(torch.equal(init_sd[n], best_sd[n]) for n in init_sd if n not in trained)
    float32 = all(t.dtype == torch.float32 for t in best_sd.values())
    # the card's own frozen parameters, after the epoch, against initial_model.pt
    # cast to their storage dtype: nothing on the card wrote to them
    changed_on_card = changed_frozen(state.model, init_sd)
    del init_sd, best_sd, state
    finite = all(np.isfinite(epoch.get(k, float("nan"))) for k in ("train_loss", "val_loss"))
    finite = finite and np.isfinite(test_metrics["test_loss"])
    steps_per_s = epoch.get("micro_steps", 0) / epoch["train_time"] if epoch else 0.0
    print(f"[train] one epoch: {epoch.get('micro_steps')} micro-steps (batch 2, 4 per update) "
          f"in {epoch.get('train_time', float('nan')):.3f} s: {steps_per_s:.3f} micro-steps/s, "
          f"{2 * steps_per_s:.3f} samples/s; epoch wall time (train + val) "
          f"{epoch.get('epoch_time', float('nan')):.3f} s; whole CLI run {wall:.1f} s",
          flush=True)
    print(f"[train] train loss {epoch.get('train_loss')}, val loss {epoch.get('val_loss')}, "
          f"test {test_metrics}; kernel launches {launches} (expected {expected}); "
          f"trained tensors moved {moved}, frozen bitwise == initial_model.pt {frozen_same}, "
          f"frozen on the card changed {changed_on_card}, float32 leaves {float32}, "
          f"missing files {missing}", flush=True)
    if not (finite and moved and frozen_same and not changed_on_card and float32
            and not missing):
        fail("training slice checks")
    if launches != expected:
        fail(f"training slice launch counts {launches} != expected {expected}")
    for name, n in launches.items():
        report[name]["launches"] = n


SOURCES = {
    "flash_attention_fwd": ("multimodal_concept_learning_tpu_torch/csrc/flash_attention_fwd.cu",
                            "multimodal_concept_learning_tpu/ops/flash_attention.py:31"),
    "flash_attention_bwd_dq": ("multimodal_concept_learning_tpu_torch/csrc/flash_attention_bwd.cu",
                               "multimodal_concept_learning_tpu/ops/flash_attention.py:52"),
    "flash_attention_bwd_dkv": ("multimodal_concept_learning_tpu_torch/csrc/flash_attention_bwd.cu",
                                "multimodal_concept_learning_tpu/ops/flash_attention.py:76"),
    "paged_decode_attention": ("multimodal_concept_learning_tpu_torch/csrc/paged_attention.cu",
                               "multimodal_concept_learning_tpu/ops/paged_attention_kernel.py:43"),
}


def main() -> None:
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    if not os.path.isdir(os.path.join(REPO, "multimodal_concept_learning_tpu_torch")):
        fail(f"no multimodal_concept_learning_tpu_torch package beside {__file__}: "
             "run this script from a checkout of the repository")
    from multimodal_concept_learning_tpu_torch.device import set_reference_numerics

    set_reference_numerics()
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    report: dict = {}
    phase_kernels(report)
    phase_parity()
    root = tempfile.mkdtemp(prefix="_smoke_results_", dir=REPO)  # listed in .gitignore
    try:
        phase_slice(report, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    serving_k1 = report["flash_attention_fwd"]["launches"]
    phase_train_parity()
    root = tempfile.mkdtemp(prefix="_smoke_train_", dir=REPO)
    try:
        phase_train_slice(report, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[timing] K1 forward launches: serving slice {serving_k1}, training slice "
          f"{report['flash_attention_fwd']['launches']}", flush=True)
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
               for name, r in report.items()]
    print(f"[timing] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
