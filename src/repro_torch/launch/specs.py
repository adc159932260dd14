"""Input specs and step-function builders for every (architecture × shape
cell), on torch's ``meta`` device. Mirror of ``repro.launch.specs``.

Nothing here allocates: the model is built on ``meta`` without a generator,
and every input is a ``meta`` tensor laid out as a DTensor by its
``Sharding`` (the reference's ``NamedSharding``-annotated
``ShapeDtypeStruct``s). A step built here runs on those inputs as it would
on real ones, each rank holding only its shards, which is what the dry-run
(``launch/dryrun.py``) measures.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeCell
from ..distributed import batch_axes, place
from ..distributed.sharding import (Sharding, logical_to_sharding, map_state, place_tensor,
                                    placements_for, shard_params, spec_entry)
from ..models import Model
from ..models.model import model_class
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import AdamWState

META = torch.device("meta")


def _on_meta(shape, dtype, sharding: Sharding):
    return place_tensor(torch.empty(shape, dtype=dtype, device=META), sharding)


def _replicated(mesh) -> Sharding:
    return Sharding(mesh, placements_for((), mesh))


def model_shapes_and_axes(model: Model):
    """(the parameters' module on ``meta``, ``{name: logical axes}``) without
    allocating: the module class is built with no generator, so its
    tensors are left uninitialised."""
    params = model_class(model.cfg)(model.cfg, device=META)
    return params, Model.logical_axes(params)


def tree_shardings(tree, axes_tree, mesh, rules=None):
    """Each tensor's ``Sharding`` by its logical axes: ``{name: Sharding}``
    for a module (``shard_params``), a twin tree for a decode state."""
    if isinstance(tree, nn.Module):
        return shard_params(tree, axes_tree, mesh, rules)
    return map_state(lambda t, ax: logical_to_sharding(t.shape, ax, mesh, rules),
                     tree, axes_tree)


def with_shardings(tree, shardings):
    """The tensors of ``tree`` laid out by ``shardings`` (its twin from
    ``tree_shardings``): a module's parameters in place, a decode state's
    tensors as a new tree."""
    if isinstance(tree, nn.Module):
        return place(tree, shardings)
    return map_state(place_tensor, tree, shardings)


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh):
    """The model inputs of one shape cell on ``meta``, laid out by their
    ``Sharding``s, and those ``Sharding``s: ``(inputs, shardings)``, two
    dicts. Token ids are int32 and embeddings bf16, as in the reference."""
    B, S = cell.global_batch, cell.seq_len
    bspec = spec_entry(batch_axes(mesh, B))

    def sharding(ndim):
        return Sharding(mesh, placements_for((bspec,) + (None,) * (ndim - 1), mesh))

    if cell.kind == "decode":
        shapes = {"tokens": ((B,), torch.int32)}
    elif cfg.input_mode == "tokens":
        shapes = {"tokens": ((B, S), torch.int32), "targets": ((B, S), torch.int32)}
    elif cfg.input_mode == "embeds":
        shapes = {"embeds": ((B, S, cfg.d_model), torch.bfloat16),
                  "targets": ((B, S), torch.int32)}
    elif cfg.input_mode == "vlm":
        sv = cfg.vision_seq
        shapes = {"vision_embeds": ((B, sv, cfg.d_model), torch.bfloat16),
                  "tokens": ((B, S - sv), torch.int32), "targets": ((B, S - sv), torch.int32)}
    else:
        raise ValueError(cfg.input_mode)
    shardings = {k: sharding(len(shape)) for k, (shape, _) in shapes.items()}
    return ({k: _on_meta(shape, dtype, shardings[k]) for k, (shape, dtype) in shapes.items()},
            shardings)


def decode_state_specs(model: Model, cell: ShapeCell, mesh):
    """The empty decode state of one decode cell on ``meta``, laid out by
    ``decode_state_axes``, and its ``Sharding``s: ``(state, shardings)``."""
    state = model.init_decode_state(cell.global_batch, cell.seq_len, device=META)
    sh = tree_shardings(state, model.decode_state_axes(), mesh)
    return with_shardings(state, sh), sh


def build_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
               opt_cfg: AdamWConfig | None = None, opt_rules: dict | None = None):
    """Returns (step_fn, example_args on ``meta``, out_shardings | None).

    step_fn signatures, the reference's:
      train:   (params, opt_state, batch) -> (params, opt_state, loss, gnorm)
      prefill: (params, batch) -> (logits, state)   (encoder: logits)
      decode:  (params, state, tokens) -> (logits, state)

    ``params`` is the model's module; the train step updates it and the
    optimizer state in place (``adamw_update``) and returns them. m and v
    share the parameters' layout unless ``opt_rules`` (a strategy's
    ``OPT_RULES``) shard them otherwise."""
    model = Model(cfg)
    params, axes = model_shapes_and_axes(model)
    p_sh = tree_shardings(params, axes, mesh)
    with_shardings(params, p_sh)
    opt_cfg = opt_cfg or AdamWConfig()

    if cell.kind == "train":
        mv_sh = tree_shardings(params, axes, mesh, opt_rules) if opt_rules is not None else p_sh
        named = dict(params.named_parameters())

        def moment(k):
            return _on_meta(named[k].shape, torch.float32, mv_sh[k])

        # the step count is a plain tensor, the same on every rank, as
        # adamw_init makes it: replicated
        o_sh = AdamWState(m=mv_sh, v=mv_sh, count=_replicated(mesh))
        opt_state = AdamWState(m={k: moment(k) for k in named}, v={k: moment(k) for k in named},
                               count=torch.zeros((), dtype=torch.int32, device=META))
        batch, _ = batch_specs(cfg, cell, mesh)

        def train_step(params, opt_state, batch):
            loss = model.loss(params, batch)
            loss.backward()
            named = dict(params.named_parameters())
            _, new_o, gnorm = adamw_update({k: p.grad for k, p in named.items()}, named,
                                           opt_state, opt_cfg)
            return params, new_o, loss, gnorm

        out_sh = (p_sh, o_sh, _replicated(mesh), _replicated(mesh))
        return train_step, (params, opt_state, batch), out_sh

    if cell.kind == "prefill":
        batch, _ = batch_specs(cfg, cell, mesh)
        if cfg.family == "encoder":
            def prefill(params, batch):
                return model.encode(params, batch)
        else:
            def prefill(params, batch):
                return model.prefill(params, batch, cell.seq_len)
        return prefill, (params, batch), None

    # decode
    state, _ = decode_state_specs(model, cell, mesh)
    batch, _ = batch_specs(cfg, cell, mesh)

    def decode(params, state, tokens):
        return model.decode_step(params, state, tokens)

    return decode, (params, state, batch["tokens"]), None
