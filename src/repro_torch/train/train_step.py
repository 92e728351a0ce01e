"""The training step — the port of the JAX package's ``train/train_step.py``
on one device with no sharder: bf16 compute off fp32 master params, the
chunked cross-entropy, the AdamW update.

JAX differentiates ``loss_fn`` through ``cast_tree`` (fp32 master -> bf16
compute copy), so each gradient is the compute-type gradient cast to fp32.
The port does the same in two halves: a module in the compute type (the
"compute model") is loaded from the masters at the start of each step, and
the gradients of its parameters, in the compute type, go to
``optim.adamw.apply_update``, which casts each to fp32 as JAX's update does.
``torch.func.functional_call`` with the bf16 copies as its parameters would
be closer to JAX's form, but the layer checkpoints recompute their forward
in the backward, after ``functional_call`` has put the module's own
parameters back, and would silently differentiate those.

A leaf whose ``ParamDef`` pins its type (the Mamba2 mixer's ``A_log``, ``D``
and ``dt_bias``, the MoE router: fp32) keeps it in the compute model, as
the JAX package's ``init_params`` and ``stack_tables`` keep it in every
model it builds, but holds the master's values rounded through the compute
type: JAX's ``cast_tree`` rounds every leaf, those included.  For the
router that matters: its logits then come from the same numbers as JAX's,
so the same experts are picked and the same tokens dropped.  The pinned
leaves' gradients stay fp32 (JAX rounds them to bf16 on the way back).

Where the compute type is the masters' (fp32 compute), the compute model is
the master model itself and nothing is copied.  A solver-family model
(``models/solver_layer.py``) always trains in fp32 on its masters, with
the steady-state MSE as its loss, whatever ``compute_dtype`` says.
"""
from __future__ import annotations

import torch

from repro_torch.models.model_zoo import batch_inputs
from repro_torch.models.transformer import StackedModel
from repro_torch.optim.adamw import AdamWConfig, apply_update, init_state
from repro_torch.train.loss import chunked_xent

MOE_AUX_WEIGHT = 0.01


def loss_fn(model: StackedModel, batch: dict, *, remat: bool = True):
    """(loss, {"nll", "aux"}) of ``batch`` ({tokens, labels} and the
    family's inputs, ``model_zoo.batch_inputs``) under the model's own
    parameters, in its type: JAX's chunked cross-entropy over every
    position (a vlm's vision positions too)."""
    hidden, aux = model(batch["tokens"], remat=remat,
                        **batch_inputs(model.cfg, batch))
    nll = chunked_xent(model.lm_head, hidden, batch["labels"],
                       valid_vocab=model.cfg.vocab_size)
    return nll + MOE_AUX_WEIGHT * aux, {"nll": nll, "aux": aux}


def compute_model(model: StackedModel,
                  compute_dtype: torch.dtype) -> StackedModel:
    """``model`` itself if it is in ``compute_dtype``, else an empty module
    of its config in that type on its device (leaves that pin their type
    keep it)."""
    if model.dtype == compute_dtype:
        return model
    return type(model)(model.cfg, device=model.device, dtype=compute_dtype)


@torch.no_grad()
def load_params(compute: StackedModel, params: dict) -> None:
    """Copy the named fp32 masters into the compute model, each cast to the
    compute type (JAX's ``cast_tree``); a pinned leaf keeps its own type
    and holds the rounded values."""
    for name, p in compute.named_parameters():
        src = params[name]
        if p.data_ptr() == src.data_ptr():
            continue
        if p.dtype != compute.dtype:
            src = src.to(compute.dtype)
        p.copy_(src)


def value_and_grad(compute: StackedModel, params: dict, batch: dict,
                   loss_of=loss_fn):
    """(loss, its parts, {name: grad in the compute type}) of the masters
    ``params`` on ``batch``, through ``compute``, under ``loss_of(model,
    batch) -> (loss, parts)``."""
    load_params(compute, params)
    names, leaves = zip(*compute.named_parameters())
    loss, parts = loss_of(compute, batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: t.detach() for k, t in parts.items()},
            dict(zip(names, grads)))


def make_train_step(model: StackedModel, opt: AdamWConfig,
                    compute_dtype: torch.dtype = torch.bfloat16):
    """train_step(state, batch) -> (state, metrics {loss, nll, aux,
    grad_norm, lr}; a solver layer's {loss, mse, aux, grad_norm, lr}) for
    the masters of ``model``'s config; the state is updated in place
    (``apply_update``)."""
    if getattr(model.cfg, "family", None) == "solver":
        # Convergence thresholds are meaningless in bf16: fp32, no copy.
        from repro_torch.models.solver_layer import solver_loss_fn
        compute, loss_of = model, solver_loss_fn
    else:
        compute, loss_of = compute_model(model, compute_dtype), loss_fn

    def train_step(state: dict, batch: dict):
        loss, parts, grads = value_and_grad(compute, state["params"], batch,
                                            loss_of)
        state, opt_metrics = apply_update(state, grads, opt)
        return state, {"loss": loss, **parts, **opt_metrics}

    return train_step


def init_train_state(model: StackedModel) -> dict:
    """The train state of an fp32 master model (``model_zoo.build(cfg,
    dtype=torch.float32)``, or a solver layer): its parameters, shared, and
    fp32 zeros for m and v; the step updates the model in place."""
    if model.dtype != torch.float32:
        raise ValueError(f"the masters must be float32, got {model.dtype}")
    return init_state({n: p.detach() for n, p in model.named_parameters()})
