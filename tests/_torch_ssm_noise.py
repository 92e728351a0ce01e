"""How far fp32 rounding carries the ssm and hybrid families, and how far a
wrong cache moves them: the measurements behind ``chip_smoke.py``'s
phase-25 tolerances and the card tests' SSM tolerances.

    PYTHONPATH=src python tests/_torch_ssm_noise.py            # CPU, fp32
    PYTHONPATH=src python tests/_torch_ssm_noise.py --fp64     # CPU, fp64
    PYTHONPATH=src python tests/_torch_ssm_noise.py --card     # the H100
    PYTHONPATH=src python tests/_torch_ssm_noise.py --card-smoke   # its
                                                  # smoke-prefill part only

Add ``--reference-decays`` to any of them to run the chunked SSD with the
reference's decays, exp(cum_i - cum_j) of one cumsum a chunk
(``src/repro/models/ssm.py:53-60``), in place of the port's per-segment
sums.  Prints one JSON line a measurement, relative to the max-abs of the
tensor it is held against.

CPU (weights seed 0, tokens seed 1; about 2 GB and a minute): each decode
step's logits against the train-mode forward's over the prompt and the
tokens so far, for mamba2-370m at 4 layers and zamba2-1.2b at 8 (one group,
its shared block, the tail), batch 1, a 300-token prompt, 4 steps; in fp32
also zamba2's prefill hidden through ``attn_impl="flash"`` (the kernel's
plain version here) against ``"xla"`` at 8-26 layers, 600 tokens.
``--fp64`` reruns the decode comparison in float64 (the model, its caches
and every ``Tensor.float()`` of the port widened, a patch of this process
only).

``--card``, on one H100 (about 25 GB of device memory and three
minutes): ``smoke_prefill`` (its docstring says what), then phase 25 (a)'s
run, each arch at full width and depth, batch 2, a
1000-token prompt, 16 greedy tokens, weights and prompts drawn as
``chip_smoke.py`` draws them, and

- fp32 (zamba2's attention through the flash kernels): decode against the
  forward at each step, and each against a float64 forward of the same
  weights over the same tokens;
- float64 (plain attention): decode against forward over the same tokens,
  which no rounding of fp32 reaches;
- the gain of the random model: the float64 prefill's logits when its
  embeddings move by 2**-24 of themselves (fp32's half ulp), at random;
- faults, each the first decode step's logits against the forward's after
  one wrong cache: the conv halo zeroed, the conv halo reversed in time,
  the SSD state read before the step's update, and (zamba2) the attention
  cache filled to one place short (``kv_len - 1``);
- phase 25 (c)'s card against CPU (2 and 8 layers, batch 2, 300 tokens):
  the fp32 prefill hidden on the card and on the CPU, each against the
  card's float64;
- the smoke configs as ``tests/test_torch_cuda.py`` runs them: the fp32
  prefill hidden, caches and 4 decode logits (2 x 37 tokens, chunk 8), and
  the gradients at chunk 256 over 2 x 512 tokens, on the card and on the
  CPU, each against the card's float64.
"""
import contextlib
import dataclasses
import json
import sys

import numpy as np
import torch


def own(model):
    """The model's parameters as ``value_and_grad``'s masters (no copy)."""
    return {n: p.detach() for n, p in model.named_parameters()}


def rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def reference_chunk(state, xdt, dA, Bc, Cc):
    """``models/ssm._ssd_chunk`` with the reference's decays: one cumsum a
    chunk, each decay exp(cum_i - cum_j)."""
    Q, cdtype = dA.shape[1], xdt.dtype
    cum = torch.cumsum(dA, dim=1)
    total = cum[:, -1]
    CB = torch.einsum("bin,bjn->bij", Cc.float(), Bc.float())
    causal = torch.ones(Q, Q, dtype=torch.bool, device=dA.device).tril()
    seg = cum[:, :, None, :] - cum[:, None, :, :]
    L = torch.exp(seg.masked_fill(~causal[None, :, :, None], -torch.inf))
    M = CB.to(cdtype).float()[..., None] * L.to(cdtype).float()
    y_diag = torch.einsum("bijh,bjhp->bihp", M, xdt.float())
    y_off = torch.einsum("bin,bhpn->bihp", Cc.float(),
                         state) * torch.exp(cum)[..., None]
    decay_to_end = torch.exp(total[:, None, :] - cum)
    new_state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
        "bjhp,bjn->bhpn", xdt.float() * decay_to_end[..., None], Bc.float())
    return new_state, y_diag + y_off


@contextlib.contextmanager
def float64():
    """Widen the port's fp32 points to float64 inside the block: every
    ``Tensor.float()``, the SSD's zero state and the caches' fp32 state."""
    import repro_torch.models.ssm as ssm
    import repro_torch.models.transformer as tr
    saved = torch.Tensor.float, ssm._ssd_chunk, tr.mamba2_cache_shapes
    chunk, shapes = ssm._ssd_chunk, tr.mamba2_cache_shapes
    torch.Tensor.float = lambda self: self.double()
    ssm._ssd_chunk = lambda state, *a: chunk(state.double(), *a)
    tr.mamba2_cache_shapes = lambda *a: {
        k: (s, torch.float64) for k, (s, _) in shapes(*a).items()}
    try:
        yield
    finally:
        torch.Tensor.float, ssm._ssd_chunk, tr.mamba2_cache_shapes = saved


def widened(model, attn_impl="xla"):
    """A float64 copy of ``model`` (every leaf, the pinned fp32 ones too)."""
    from repro_torch.models.transformer import Transformer
    cfg = dataclasses.replace(model.cfg, attn_impl=attn_impl)
    out = Transformer(cfg, device=model.device, dtype=torch.float64)
    out.load_state_dict({k: v.double() for k, v in
                         model.state_dict().items()})
    for p in out.parameters():
        p.data = p.data.double()
    return out


def last_logits(model, seq):
    from repro_torch.models.transformer import mask_pad_logits
    with torch.no_grad():
        hidden, _ = model(seq, remat=False)
        return mask_pad_logits(model.logits(hidden[:, -1]), model.cfg)


def decode_run(model, prompts, steps, tokens=None, fault=None):
    """Prefill, then ``steps`` decode steps: each step's (decode logits,
    forward logits) over the same tokens, and the tokens fed.  ``tokens``
    (B, steps) feeds those in place of the greedy ones; ``fault(cache)``
    corrupts the cache after the prefill, and the decode step's ``kv_len``
    with ``fault.kv_shift``."""
    from repro_torch.models.transformer import mask_pad_logits
    B, S = prompts.shape
    V = model.cfg.vocab_size
    h, cache = model.prefill(prompts, S + steps + 1)
    with torch.no_grad():
        tok = torch.argmax(mask_pad_logits(model.logits(h), model.cfg), -1)
    if fault is not None:
        fault(cache)
    shift = getattr(fault, "kv_shift", 0)
    seq, out, fed = prompts, [], []
    for i in range(steps):
        if tokens is not None:
            tok = tokens[:, i]
        fed.append(tok)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        logits, cache = model.decode_step(tok, cache, S + i + shift)
        out.append((logits[:, :V], last_logits(model, seq)[:, :V]))
        tok = torch.argmax(logits, -1)
    return out, torch.stack(fed, 1)


def decode_against_forward(arch, n_layers, dtype, steps=4, prompt=300):
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              attn_impl="xla")
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    if dtype == torch.float64:
        model = widened(model)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out, _ = decode_run(model, tokens, steps)
    return [rel(a, b) for a, b in out]


def flash_against_xla(n_layers, prompt=600):
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build
    from repro_torch.models.transformer import Transformer
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=n_layers,
                              attn_impl="flash")
    flash = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    xla = Transformer(dataclasses.replace(cfg, attn_impl="xla"),
                      device="cpu")
    xla.load_state_dict(flash.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt),
                           generator=torch.Generator().manual_seed(1))
    h, _ = flash.prefill(tokens, prompt)
    hx, _ = xla.prefill(tokens, prompt)
    return rel(h, hx)


# -- faults: each corrupts the cache after the prefill ----------------------

def _mamba_caches(cache):
    if "groups" in cache:
        return [cache["groups"]] + ([cache["tail"]] if "tail" in cache
                                    else [])
    return [cache]


def halo_zeroed(cache):
    for c in _mamba_caches(cache):
        c["conv_x"].zero_()
        c["conv_bc"].zero_()


def halo_reversed(cache):
    for c in _mamba_caches(cache):
        for name in ("conv_x", "conv_bc"):
            c[name].copy_(c[name].flip(-2))


def kv_short(cache):
    pass


kv_short.kv_shift = -1


@contextlib.contextmanager
def state_read_before_update():
    """``mamba2_decode`` with y = C . state taken before the step's update:
    the current token's own term drops out of y."""
    import repro_torch.models.ssm as ssm
    saved = ssm.torch.einsum
    calls = {}

    def einsum(eq, *ops):
        if eq == "bh,bhp,bn->bhpn":
            calls["update"] = saved(eq, *ops)
            return calls["update"]
        if eq == "bhpn,bn->bhp" and "update" in calls:
            ops = (ops[0] - calls.pop("update"), *ops[1:])
        return saved(eq, *ops)

    ssm.torch.einsum = einsum
    try:
        yield
    finally:
        ssm.torch.einsum = saved


def smoke_prefill(emit, dev):
    """The card tests' smoke prefill (fp32, 2 x 37 tokens, weights seed 0
    as ``model_zoo.build`` draws them, tokens from seeds 0-3): the hidden
    and the worst cache leaf on the card through ``attn_impl="flash"`` and
    ``"xla"`` and on the CPU, each against the card's float64; and K7 alone
    at the hybrid smoke's attention shape against its float64 plain
    version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_trainable)
    from repro_torch.models.attention import attention
    from repro_torch.models.layers import flatten
    from repro_torch.models.model_zoo import build
    from repro_torch.models.transformer import Transformer
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  attn_impl="flash")
        gpu = build(cfg, device=dev, dtype=torch.float32)
        xla = Transformer(dataclasses.replace(cfg, attn_impl="xla"),
                          device=dev)
        xla.load_state_dict(gpu.state_dict())
        cpu = Transformer(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        wide = widened(gpu)
        for seed in range(4):
            toks = torch.randint(0, cfg.vocab_size, (2, 37),
                                 generator=torch.Generator().manual_seed(seed))
            runs = {"card_flash": gpu.prefill(toks.to(dev), 48),
                    "card_xla": xla.prefill(toks.to(dev), 48),
                    "cpu": cpu.prefill(toks, 48)}
            with float64():
                h64, c64 = wide.prefill(toks.to(dev), 48)
            leaves64 = dict(flatten(c64))
            out = {"arch": arch, "what": "smoke_prefill", "tokens_seed": seed}
            for name, (h, c) in runs.items():
                out[name + "_hidden_vs_fp64"] = rel(h, h64)
                out[name + "_cache_vs_fp64_worst"] = max(
                    rel(t, leaves64[path]) for path, t in flatten(c)
                    if leaves64[path].abs().max() > 0)
            out["card_flash_vs_cpu_hidden"] = rel(runs["card_flash"][0],
                                                  runs["cpu"][0])
            emit(out)
        if cfg.family == "hybrid":
            g = torch.Generator().manual_seed(6)
            q, k, v = (torch.randn(2, 37, cfg.n_heads, cfg.head_dim,
                                   generator=g) for _ in range(3))
            got = flash_attention_trainable(q.to(dev), k.to(dev), v.to(dev),
                                            True, 512, 512, 0)
            want = attention(q.double(), k.double(), v.double(), causal=True,
                             q_chunk=cfg.q_chunk)
            emit({"arch": arch, "what": "smoke_k7_fp32_vs_fp64",
                  "shape": list(q.shape), "rel_err": rel(got, want)})
        del gpu, xla, cpu, wide


def card(emit, dev):
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.data.synthetic import DataConfig, token_batch
    torch.backends.cuda.matmul.allow_tf32 = False   # the default, stated
    B, S, T = 2, 1000, 16                 # chip_smoke.SSM_FP32
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
        model = build(cfg, device=dev, dtype=torch.float32,
                      generator=torch.Generator(device=dev).manual_seed(0))
        prompts = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S)), device=dev)
        out, fed = decode_run(model, prompts, T)
        wide = widened(model)
        with float64():
            out64, _ = decode_run(wide, prompts, T, tokens=fed)
        emit({"arch": arch, "what": "decode_vs_forward", "batch": B,
              "prompt": S, "steps": T,
              "fp32": [rel(d, f) for d, f in out],
              "fp32_decode_vs_fp64": [rel(d, f64) for (d, _), (_, f64)
                                      in zip(out, out64)],
              "fp32_forward_vs_fp64": [rel(f, f64) for (_, f), (_, f64)
                                       in zip(out, out64)],
              "fp64": [rel(d, f) for d, f in out64]})
        # The model's gain on one fp32 rounding of its input.
        with float64():
            gen = torch.Generator(device=dev).manual_seed(3)
            h0, _ = wide.prefill(prompts, S)
            embed = wide._embed
            wide._embed = lambda t: (lambda e: e * (1 + 2.0 ** -24 * (
                2 * torch.rand(e.shape, device=dev, dtype=e.dtype,
                               generator=gen) - 1)))(embed(t))
            h1, _ = wide.prefill(prompts, S)
            wide._embed = embed
            gain = rel(wide.logits(h1), wide.logits(h0))
        emit({"arch": arch, "what": "gain", "embed_rel_noise": 2.0 ** -24,
              "logits_rel_change": gain})
        del wide
        faults = {"halo_zeroed": halo_zeroed, "halo_reversed": halo_reversed}
        if cfg.family == "hybrid":
            faults["kv_len_short"] = kv_short
        readings = {}
        for name, fault in faults.items():
            bad, _ = decode_run(model, prompts, 1, tokens=fed, fault=fault)
            readings[name] = rel(*bad[0])
        with state_read_before_update():
            bad, _ = decode_run(model, prompts, 1, tokens=fed)
        readings["state_read_before_update"] = rel(*bad[0])
        emit({"arch": arch, "what": "faults", "first_step": readings})
        del model
        torch.cuda.empty_cache()

        # Phase 25 (c): the card against the CPU, depth cut.
        small = dataclasses.replace(
            cfg, n_layers={"mamba2-370m": 2, "zamba2-1.2b": 8}[arch])
        gpu = build(small, device=dev, dtype=torch.float32,
                    generator=torch.Generator(device=dev).manual_seed(2))
        cpu = Transformer(small, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                   (2, 300))
        h_gpu, _ = gpu.prefill(torch.as_tensor(tokens, device=dev), 300)
        h_cpu, _ = cpu.prefill(torch.as_tensor(tokens), 300)
        wide = widened(gpu)
        with float64():
            h64, _ = wide.prefill(torch.as_tensor(tokens, device=dev), 300)
        emit({"arch": arch, "what": "card_vs_cpu", "n_layers": small.n_layers,
              "card_vs_cpu": rel(h_gpu, h_cpu),
              "card_vs_fp64": rel(h_gpu, h64), "cpu_vs_fp64": rel(h_cpu, h64)})
        del gpu, cpu, wide
        torch.cuda.empty_cache()

        # The card tests' smoke runs.
        smoke = dataclasses.replace(get_config(arch, smoke=True),
                                    attn_impl="flash")
        gpu = build(smoke, device=dev, dtype=torch.float32)
        cpu = Transformer(smoke, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        wide = widened(gpu)
        toks = torch.randint(0, smoke.vocab_size, (2, 37),
                             generator=torch.Generator().manual_seed(5))
        runs = {}
        runs["cpu"], fed = decode_run(cpu, toks, 4)
        runs["card"], _ = decode_run(gpu, toks.to(dev), 4,
                                     tokens=fed.to(dev))
        with float64():
            runs["fp64"], _ = decode_run(wide, toks.to(dev), 4,
                                         tokens=fed.to(dev))
        emit({"arch": arch, "what": "smoke_decode", "card_vs_cpu":
              [rel(a[0], b[0]) for a, b in zip(runs["card"], runs["cpu"])],
              "card_vs_fp64": [rel(a[0], b[1]) for a, b in
                               zip(runs["card"], runs["fp64"])],
              "cpu_vs_fp64": [rel(a[0], b[1]) for a, b in
                              zip(runs["cpu"], runs["fp64"])]})
        del gpu, cpu, wide
        c256 = dataclasses.replace(smoke, ssm_chunk=256)
        gpu = build(c256, device=dev, dtype=torch.float32)
        cpu = Transformer(c256, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        wide = widened(gpu)
        batch = token_batch(DataConfig(smoke.vocab_size, 512, 2), 0,
                            device=dev)
        grads = {}
        for name, m, b in (("card", gpu, batch),
                           ("cpu", cpu, {k: v.cpu()
                                         for k, v in batch.items()})):
            grads[name] = value_and_grad(m, own(m), b)[2]
        with float64():
            grads["fp64"] = value_and_grad(wide, own(wide), batch)[2]
        worst = lambda a: max(
            (rel(grads[a][k], grads["fp64"][k]), k) for k in grads["fp64"])
        emit({"arch": arch, "what": "smoke_grads_chunk256",
              "card_vs_cpu_worst": max((rel(grads["card"][k],
                                            grads["cpu"][k]), k)
                                       for k in grads["cpu"]),
              "card_vs_fp64_worst": worst("card"),
              "cpu_vs_fp64_worst": worst("cpu")})
        del gpu, cpu, wide
        torch.cuda.empty_cache()


def main(argv) -> int:
    emit = lambda obj: print(json.dumps(obj), flush=True)
    if "--reference-decays" in argv:
        import repro_torch.models.ssm as ssm
        ssm._ssd_chunk = reference_chunk
        emit({"decays": "reference"})
    if "--card" in argv or "--card-smoke" in argv:
        if not torch.cuda.is_available():
            print("--card needs a CUDA device", file=sys.stderr)
            return 1
        smoke_prefill(emit, torch.device("cuda"))
        if "--card" in argv:
            card(emit, torch.device("cuda"))
        return 0
    fp64 = "--fp64" in argv
    dtype = torch.float64 if fp64 else torch.float32
    for arch, n in (("mamba2-370m", 4), ("zamba2-1.2b", 8)):
        ctx = float64() if fp64 else contextlib.nullcontext()
        with ctx:
            errs = decode_against_forward(arch, n, dtype)
        emit({"arch": arch, "n_layers": n, "dtype": str(dtype).split(".")[1],
              "decode_vs_forward_by_step": errs})
    if not fp64:
        for n in (8, 14, 20, 26):
            emit({"arch": "zamba2-1.2b", "n_layers": n,
                  "flash_vs_xla_hidden": flash_against_xla(n)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
