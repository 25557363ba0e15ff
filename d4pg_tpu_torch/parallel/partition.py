"""Partition rules and the sharded train state (counterpart of
``d4pg_tpu/parallel/partition.py``).

The rule tables are the JAX package's, copied: ``(regex, spec)`` pairs
matched first-match against a leaf's Flax path name
(``params/hidden_0/kernel``, ``params/PixelEncoder_0/Conv_0/kernel``),
with the Flax ``[in, out]`` kernel layout. :data:`DEFAULT_RULES` is the
Megatron pattern on a ``("dp", "tp")`` mesh: ``hidden_0`` and
``hidden_2`` column-split (``P(None, "tp")``, biases on ``P("tp")``),
``hidden_1`` and ``out`` row-split (``P("tp", None)``), every other leaf
replicated. A leaf whose rank disagrees with its rule, or whose sharded
dim the mesh does not divide, replicates instead; :func:`explain_partition_rules`
names the outcome of every leaf, as the JAX function does.

A spec (:class:`P`) is a tuple of mesh axis names or ``None``, one per
dim (``P()`` replicates). The port's modules keep their own layouts
(``nn.Linear.weight`` is ``[out, in]``, a conv weight OIHW), so
:func:`module_specs` matches on the Flax view of each parameter and
hands back the spec in the parameter's own layout: a column split of a
kernel is a split of ``weight``'s dim 0.

:func:`state_specs` gives the four networks' specs (the Adam moments of
a parameter follow it); :func:`make_shard_and_gather_fns` cuts a whole
tensor into its ``tp`` lane shards and concatenates them back exactly;
:func:`shard_train_state` builds the sharded state of ``parallel/tp.py``
and :func:`auto_parallel_train_step` its step, the counterpart of the
JAX package's GSPMD ``jit``. :data:`RING_RULES` and
:data:`PER_TREE_RULES` are read by ``replay/device_ring.py`` and
``replay/device_per.py`` (:func:`ring_partition_specs`,
:func:`tree_partition_specs`), which lay their ``dp`` lanes out by them.
"""

from __future__ import annotations

import math
import re
from typing import Mapping, Sequence

import torch


class P(tuple):
    """A partition spec: one mesh axis name (or ``None``) per dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# (regex over 'path/to/param', spec). First match wins.
DEFAULT_RULES: Sequence[tuple[str, P]] = (
    (r"hidden_0/kernel", P(None, "tp")),
    (r"hidden_1/kernel", P("tp", None)),
    (r"hidden_2/kernel", P(None, "tp")),
    (r"out/kernel", P("tp", None)),
    (r"hidden_0/bias", P("tp")),
    (r"hidden_2/bias", P("tp")),
    (r".*bias", P()),
    (r".*", P()),
)

# (stack size, stack axis): a leaf with one more leading dim than its rule,
# of a declared size, is a stacked variant (twin critics: 2, replicated).
DEFAULT_STACK_AXES: Sequence[tuple[int, str | None]] = ((2, None),)

# The device ring's fields: rows shard over "dp", the fill count replicates.
RING_RULES: Sequence[tuple[str, P]] = (
    (r"obs|action|next_obs", P("dp", None)),
    (r"reward|discount", P("dp")),
    (r"size", P()),
    (r".*", P()),
)

# The device PER tree's fields: the [S, 2L] lane-major sums over "dp", the
# max-priority scalar replicated.
PER_TREE_RULES: Sequence[tuple[str, P]] = (
    (r"sums", P("dp", None)),
    (r"max_priority", P()),
    (r".*", P()),
)


def stack_axes_for(config, ensemble_axis: str | None = None):
    """The stacked-variant declarations for a config: the twin pair (its
    stack replicates) and, with ``config.critic_ensemble``, the E-wide
    ensemble stack over ``ensemble_axis`` ("tp": each tp lane holds E/tp
    whole members; None: replicated)."""
    axes = list(DEFAULT_STACK_AXES)
    ensemble = getattr(config, "critic_ensemble", 0)
    if ensemble:
        axes.append((int(ensemble), ensemble_axis))
    return tuple(axes)


def _axis_size(mesh, axis) -> int:
    axes = axis if isinstance(axis, tuple) else (axis,)
    return math.prod(int(mesh.shape[a]) for a in axes)


def _spec_fits(spec: P, shape, mesh) -> bool:
    """A spec fits iff every sharded dim divides by its mesh axes' size."""
    if mesh is None:
        return True
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim >= len(shape) or shape[dim] % _axis_size(mesh, axis) != 0:
            return False
    return True


def _leaf_spec(name: str, shape, rules, mesh, declared_stacks: dict) -> tuple[P, dict]:
    """First-match rule application for ONE leaf -> ``(spec, info)``;
    ``info["outcome"]`` is ``scalar``, ``rule``, ``stack``,
    ``fallback_rank``, ``fallback_fit``, ``fallback_catchall`` or
    ``fallback_nomatch`` (the JAX ``_leaf_spec``'s)."""
    ndim = len(shape)
    size = math.prod(shape) if shape else 1
    if ndim == 0 or size == 1:
        return P(), {"outcome": "scalar", "rule": None}
    for pattern, spec in rules:
        if re.search(pattern, name):
            outcome = "rule"
            if len(spec) and ndim == len(spec) + 1 and shape[0] in declared_stacks:
                stack_ax = declared_stacks[shape[0]]
                trailing = tuple(spec)
                if stack_ax is not None:
                    # member-parallel: each member stays whole on its lane
                    trailing = tuple(
                        None if a == stack_ax or (isinstance(a, tuple) and stack_ax in a) else a
                        for a in trailing
                    )
                spec = P(stack_ax, *trailing)
                outcome = "stack"
            if len(spec) not in (0, ndim):
                spec = P()
                outcome = "fallback_rank"
            if not _spec_fits(spec, shape, mesh):
                spec = P()
                outcome = "fallback_fit"
            if outcome == "rule" and pattern == r".*":
                outcome = "fallback_catchall"
            return P(*spec), {"outcome": outcome, "rule": pattern}
    return P(), {"outcome": "fallback_nomatch", "rule": None}


def _shape_of(leaf) -> tuple:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def _named_leaves(tree: Mapping, prefix: str = "") -> list:
    """``(path, leaf)`` of a nested dict in ``jax.tree_util`` flatten order
    (sorted keys, depth first), paths joined by ``/``."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        out.extend(_named_leaves(v, path + "/") if isinstance(v, Mapping) else [(path, v)])
    return out


def explain_partition_rules(rules, tree: Mapping, mesh=None,
                            stack_axes=DEFAULT_STACK_AXES) -> list[dict]:
    """``[{name, shape, spec, outcome, rule}]`` for every leaf of a nested
    dict of arrays (anything with ``.shape``), in flatten order."""
    declared = dict(stack_axes)
    out = []
    for name, leaf in _named_leaves(tree):
        shape = _shape_of(leaf)
        spec, info = _leaf_spec(name, shape, rules, mesh, declared)
        out.append({"name": name, "shape": shape, "spec": spec, **info})
    return out


def match_partition_rules(rules, tree: Mapping, mesh=None, stack_axes=DEFAULT_STACK_AXES):
    """The spec of every leaf of a nested dict, as the same nested dict."""
    specs = {e["name"]: e["spec"] for e in explain_partition_rules(rules, tree, mesh, stack_axes)}

    def build(node: Mapping, prefix: str):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, Mapping) else specs[f"{prefix}{k}"]
                for k, v in node.items()}

    return build(tree, "")


# ------------------------------------------------- the port's parameters
def flax_view(name: str, shape: tuple) -> tuple[str, tuple, tuple]:
    """A port parameter (``state_dict`` name and shape) → its Flax path
    name, its Flax shape, and ``perm``: port dim ``i`` is Flax dim
    ``perm[i]`` (the mapping of ``weights.py``: a 2-D ``weight`` is a
    transposed Dense kernel, a 4-D one an OIHW conv kernel of an HWIO
    Flax kernel, a 1-D one a LayerNorm ``scale``; stacked leaves keep
    the Flax layout)."""
    *path, kind = name.split(".")
    perm = tuple(range(len(shape)))
    if kind == "weight":
        if len(shape) == 2:
            kind, perm = "kernel", (1, 0)
        elif len(shape) == 4:
            kind, perm = "kernel", (3, 2, 0, 1)
        else:
            kind = "scale"
    flax_shape = [0] * len(shape)
    for i, d in enumerate(perm):
        flax_shape[d] = shape[i]
    return "/".join(["params", *path, kind]), tuple(flax_shape), perm


def module_specs(module: torch.nn.Module, mesh=None, rules=DEFAULT_RULES,
                 stack_axes=DEFAULT_STACK_AXES) -> dict:
    """``{parameter name: spec}`` of a port network, each spec in the
    parameter's own layout and of its full rank (``P()`` spelled out as
    all ``None``)."""
    declared = dict(stack_axes)
    out = {}
    for name, p in module.named_parameters():
        flax_name, flax_shape, perm = flax_view(name, tuple(p.shape))
        spec, _ = _leaf_spec(flax_name, flax_shape, rules, mesh, declared)
        full = tuple(spec) + (None,) * (len(flax_shape) - len(spec))
        out[name] = P(*(full[d] for d in perm))
    return out


NETWORKS = ("actor", "critic", "target_actor", "target_critic")


def state_specs(state, mesh=None, rules=DEFAULT_RULES, stack_axes=DEFAULT_STACK_AXES) -> dict:
    """The specs of a whole train state: ``{network: {parameter: spec}}``
    for the actor, the critic and their targets. A parameter's two Adam
    moments take its spec; the step, Adam's count and the generators
    replicate."""
    return {net: module_specs(getattr(state, net), mesh, rules, stack_axes) for net in NETWORKS}


def tp_dim(spec: P) -> int | None:
    """The dim a spec splits over "tp", or None (replicated over tp)."""
    dims = [i for i, a in enumerate(spec) if a == "tp" or (isinstance(a, tuple) and "tp" in a)]
    if len(dims) > 1:
        raise ValueError(f"spec {spec!r} names tp on more than one dim")
    return dims[0] if dims else None


def make_shard_and_gather_fns(specs: Mapping, mesh) -> tuple[dict, dict]:
    """``(shard_fns, gather_fns)`` keyed as ``specs`` (``{name: spec}``).
    ``shard_fns[name](whole)`` → the ``tp`` lane shards of a whole tensor
    (contiguous copies, lane order); ``gather_fns[name](shards)`` → the
    whole tensor again, their concatenation on the split dim (lane 0's
    copy for a replicated leaf). Exact: ``gather ∘ shard`` is the
    identity."""
    tp = int(mesh.shape["tp"])

    def shard(spec):
        dim = tp_dim(spec)

        def fn(x: torch.Tensor) -> list:
            if dim is None:
                return [x.detach().clone() for _ in range(tp)]
            if x.shape[dim] % tp:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible by tp={tp}")
            return [c.contiguous().clone() for c in x.detach().chunk(tp, dim)]
        return fn

    def gather(spec):
        dim = tp_dim(spec)

        def fn(shards: Sequence[torch.Tensor]) -> torch.Tensor:
            if dim is None:
                return shards[0].detach().clone()
            return torch.cat([s.detach() for s in shards], dim)
        return fn

    return ({k: shard(s) for k, s in specs.items()}, {k: gather(s) for k, s in specs.items()})


def shard_train_state(state, mesh, rules=DEFAULT_RULES, stack_axes=DEFAULT_STACK_AXES):
    """A whole :class:`~d4pg_tpu_torch.agent.state.TrainState` → its
    sharded :class:`~d4pg_tpu_torch.parallel.tp.TPTrainState` over
    ``mesh.tp`` lanes (params, targets and Adam moments cut by the shard
    fns; ``state`` itself is left as it is)."""
    from d4pg_tpu_torch.parallel.tp import TPTrainState

    return TPTrainState(state, mesh, state_specs(state, mesh, rules, stack_axes))


def shard_batch(batch: Mapping, mesh) -> list:
    """A batch's rows as ``mesh.dp`` contiguous lane shards (``P("dp")``;
    every tp lane of a dp row reads the same shard)."""
    from d4pg_tpu_torch.parallel.dp import split_lanes

    return split_lanes(dict(batch), mesh.dp)


def auto_parallel_train_step(config, mesh, rules=DEFAULT_RULES, ensemble_axis: str | None = None):
    """``(state, batch) -> (state, metrics, priorities)``: the tensor- and
    data-parallel grad step over this process's ``dp × tp`` lanes, in
    place on a state from :func:`shard_train_state` (``step.shard(state)``
    shards a whole state with this step's rules and stack axes). Each dp
    lane runs the Megatron forward over its tp lanes, the critic loss
    once on the combined logits, and the gradients of each tp index are
    combined over the dp lanes by the fixed-order mean.

    In one process a call runs through a compiled program
    (``parallel/dp.py:lane_program``, the JAX package's ``jit``), one for
    each state it is given (``step.programs``: (state, program) pairs), so
    a replay on the card reads that state's tensors by address; the step
    count advances here, outside the program. Over several processes the
    step stays eager (its combines cross the processes on the host)."""
    from d4pg_tpu_torch.parallel.dp import lane_program, make_dp_train_step

    stack_axes = stack_axes_for(config, ensemble_axis)
    inner = make_dp_train_step(config, mesh)
    programs: list = []

    def program(state):
        for st, prog in programs:
            if st is state:
                return prog
        prog = lane_program("train_step", lambda batch: inner(state, batch)[1:], lambda: [state],
                            [inner.sync])
        programs.append((state, prog))
        return prog

    def step(state, batch):
        if getattr(state, "tp", None) != mesh.tp:
            raise TypeError(
                f"auto_parallel_train_step over tp={mesh.tp} needs the state sharded over "
                "that many lanes: pass step.shard(state) (or shard_train_state)")
        if mesh.num_processes > 1:
            return inner(state, batch)
        k = state.step
        metrics, priorities = program(state)(batch)
        state.step = k + 1
        return state, metrics, priorities

    step.shard = lambda state: shard_train_state(state, mesh, rules, stack_axes)
    step.sync = inner.sync
    step.stack_axes = stack_axes
    step.programs = programs
    return step


# ------------------------------------------------------------- replay
def _field_specs(rules, fields: Mapping) -> dict:
    return {e["name"]: e["spec"] for e in explain_partition_rules(rules, fields)}


def ring_partition_specs(fields: Mapping) -> dict:
    """``{field: spec}`` of a device ring (``{name: tensor}``, the global
    view) from :data:`RING_RULES`."""
    return _field_specs(RING_RULES, fields)


def tree_partition_specs(fields: Mapping) -> dict:
    """``{field: spec}`` of the device PER tree's global view (``sums``
    [S, 2L], ``max_priority``) from :data:`PER_TREE_RULES`."""
    return _field_specs(PER_TREE_RULES, fields)


def dp_fields(specs: Mapping) -> tuple:
    """The fields a spec table shards over "dp" (on their leading dim)."""
    return tuple(k for k, s in specs.items() if len(s) and s[0] == "dp")
