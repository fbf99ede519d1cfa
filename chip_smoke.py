"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, on a line of their own;
2. build: compile the port's CUDA kernels from ``csrc/`` (timed);
3. kernels: each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the serving path's shapes (max abs error, and
   kernel vs plain time from CUDA events);
4. parity: float32 MLLM at full width and reduced depth, ``paged_generate``
   on the card (through both kernels) must give exactly the greedy tokens
   of the same weights on the CPU plain path;
5. slice: a seeded random-init results dir of the full ``12_colors_3k``
   configuration, served by the port's paged server (``make_server``):
   16 requests from 16 threads, ``/healthz`` and ``/metrics`` over HTTP,
   launch counts of both kernels.

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


SOURCES = {
    "flash_attention_fwd": ("multimodal_concept_learning_tpu_torch/csrc/flash_attention_fwd.cu",
                            "multimodal_concept_learning_tpu/ops/flash_attention.py:31"),
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
