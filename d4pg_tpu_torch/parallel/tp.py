"""Tensor parallelism over tp lanes: the sharded networks and train state
(the port's counterpart of what GSPMD does with the JAX package's
``auto_parallel_train_step``).

A :class:`TPModule` holds one network (an ``Actor``, a ``Critic`` or a
``StackedCritic``) cut into ``tp`` lane modules by its specs
(``parallel/partition.py:module_specs``): each lane module has the whole
network's structure and parameter names, with each parameter its lane's
shard (a replicated parameter whole, a copy on every lane). Its forward
is the Megatron forward over the lanes, one Dense layer at a time, by
the kind of the layer's kernel spec:

- **column** (Flax ``P(None, "tp")``): every lane multiplies the whole
  input by its column shard and adds its bias shard; the activation stays
  split by features, one piece a lane (:class:`Pieces`);
- **row** (``P("tp", None)``): lane ``t`` multiplies input features
  ``[t·in/tp, (t+1)·in/tp)`` by its row shard, the partials are added in a
  fixed order, lane 0 to tp−1, in the compute dtype, then the replicated
  bias once: the only cross-lane arithmetic of the forward. A split
  input whose pieces do not line up with the rows (the critic's
  ``hidden_1`` when ``tp`` divides ``hidden + action_dim``: the action
  joins after ``hidden_0``'s column split) is gathered exactly (a
  concatenation) and sliced;
- **replicated** (``P()``, a fallback): lane 0's copy on the whole input;
- **member** (a stack axis over ``tp``: ``ensemble_axis="tp"``): each
  lane runs its E/tp whole members (:class:`Members`), reading a
  replicated leaf's rows of those members from lane 0's copy.

Replicated leaves (the row layers' biases, fallbacks, the pixel
encoder) are read from lane 0 only, so autograd gives lane 0's copy the
gradient; :meth:`TPModule.grad_sources` hands that same gradient to every
lane's copy (``agent/d4pg.py:_flat_grads``), and the copies, stepped by
identical Adam updates, stay ``torch.equal``. Every lane of a process
runs in that process (``parallel/mesh.py``), so no combine crosses ranks
and autograd through the adds is the backward.

:class:`TPTrainState` is a :class:`~d4pg_tpu_torch.agent.state.TrainState`
of four TPModules and two Adams over their lanes' shards (a parameter's
moments are its shards' moments). ``whole()`` gathers it into a whole
state (the checkpoint's layout) and ``load_whole()`` shards a whole one
into it in place (``--resume``), so a checkpoint moves between any tp.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from d4pg_tpu_torch.agent.state import TrainState
from d4pg_tpu_torch.models.critic import Critic, StackedCritic
from d4pg_tpu_torch.parallel.partition import NETWORKS, make_shard_and_gather_fns, tp_dim


class Pieces(list):
    """An activation split by features: one piece a tp lane, in order."""


class Members(list):
    """A stacked activation split by members: one [E/tp, ...] block a lane."""


def full(x):
    """The whole activation: split pieces or member blocks concatenated
    (an exact gather), a tensor as it is."""
    if isinstance(x, Pieces):
        return torch.cat(list(x), -1)
    if isinstance(x, Members):
        return torch.cat(list(x), 0)
    return x


def _map(fn, x):
    return type(x)(fn(v) for v in x) if isinstance(x, (Pieces, Members)) else fn(x)


def _set_param(module: nn.Module, name: str, value: nn.Parameter) -> None:
    prefix, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(prefix) if prefix else module, leaf, value)


class _TP:
    def __init__(self, tp: int):
        self.shape = {"tp": tp}


class TPModule(nn.Module):
    """One network over ``tp`` lanes (see the module docstring).
    ``forward`` takes the whole network's arguments and returns its
    whole output."""

    def __init__(self, whole: nn.Module, specs: dict, tp: int):
        super().__init__()
        self.tp = int(tp)
        self.specs = dict(specs)
        self.stacked = isinstance(whole, StackedCritic)
        self.is_critic = isinstance(whole, (Critic, StackedCritic))
        self.num_hidden = whole.num_hidden
        self.compute_dtype = whole.compute_dtype
        self.pixels = whole.pixels
        self.num_members = whole.num_members if self.stacked else 0
        for name, spec in self.specs.items():
            if name.startswith("PixelEncoder_0.") and tp_dim(spec) is not None:
                raise NotImplementedError(
                    f"{name}: a tp-sharded pixel encoder leaf ({spec!r}); the tp forward "
                    "runs the encoder replicated")
        self._shard, self._gather = make_shard_and_gather_fns(self.specs, _TP(self.tp))
        lanes = [copy.deepcopy(whole) for _ in range(self.tp)]
        for name, p in whole.named_parameters():
            for lane, s in zip(lanes, self._shard[name](p)):
                _set_param(lane, name, nn.Parameter(s, requires_grad=p.requires_grad))
        self.lanes = nn.ModuleList(lanes)
        self.layers = [f"hidden_{i}" for i in range(self.num_hidden)] + ["out"]
        self.kinds = {layer: self._kind(layer) for layer in self.layers}
        member = self.kinds["out"] == "member"
        self.member_parts = [self.num_members // self.tp] * self.tp if member else None

    # ------------------------------------------------------------ layout
    def _kind(self, layer: str) -> str:
        if self.stacked:
            stack, *trailing = self.specs[f"{layer}.kernel"]
            bias = self.specs[f"{layer}.bias"]
        else:
            out_ax, in_ax = self.specs[f"{layer}.weight"]
            stack, trailing, bias = None, [in_ax, out_ax], self.specs[f"{layer}.bias"]
        if stack == "tp" and trailing == [None, None]:
            kind = "member"
        elif stack is not None:
            raise NotImplementedError(f"{layer}: stack axis over {stack!r}")
        else:
            kind = {(None, "tp"): "col", ("tp", None): "row", (None, None): "rep"}.get(
                tuple(trailing))
        if kind is None:
            raise NotImplementedError(f"{layer}: kernel spec {trailing!r}")
        # the bias must lie as its layer's output does
        want = {"col": (len(bias) - 1,), "member": (0, None)}.get(kind, (None,))
        if tp_dim(bias) not in want:
            raise NotImplementedError(f"{layer}: bias spec {bias!r} under a {kind} kernel")
        return kind

    def grad_sources(self) -> list:
        """For each parameter in ``parameters()`` order (lane-major), the
        index of the parameter whose gradient it takes: itself for a
        shard, lane 0's copy for a replicated leaf."""
        names = [n for n, _ in self.lanes[0].named_parameters()]
        n = len(names)
        return [i if t and tp_dim(self.specs[name]) is None else t * n + i
                for t in range(self.tp) for i, name in enumerate(names)]

    def lane_numels(self) -> list:
        """Each tp lane's parameter count (its slice of a flat row)."""
        return [sum(p.numel() for p in lane.parameters()) for lane in self.lanes]

    def lane_params(self, name: str) -> list:
        return [lane.get_parameter(name) for lane in self.lanes]

    # ----------------------------------------------------------- forward
    def _product(self, t: int, layer: str, x, member, bias: bool, rows=None):
        """Lane ``t``'s product of ``layer`` on ``x`` in the compute dtype,
        plus its own bias (``bias``), or the bias rows ``rows`` of lane 0's
        replicated copy (member layers)."""
        mod = self.lanes[t].get_submodule(layer)
        dt = self.compute_dtype
        if self.stacked:
            k = mod.kernel if member is None else mod.kernel[member]
            y = torch.matmul(x.to(dt), k.to(dt))
        elif dt == torch.float32:
            return F.linear(x, mod.weight, mod.bias if bias else None)
        else:
            y = x.to(dt) @ mod.weight.to(dt).t()
        if rows is not None:
            b = self.lanes[0].get_submodule(layer).bias[rows]
        elif bias:
            b = mod.bias
        else:
            return y
        if self.stacked:
            b = b[member] if member is not None else b.unsqueeze(-2)
        return y + b.to(dt)

    def _shared_bias(self, layer: str, member):
        b = self.lanes[0].get_submodule(layer).bias
        if self.stacked:
            b = b[member] if member is not None else b.unsqueeze(-2)
        return b.to(self.compute_dtype)

    def _apply(self, layer: str, x, member, stacked_act: bool):
        kind, tp = self.kinds[layer], self.tp
        if kind == "rep":
            return self._product(0, layer, full(x), member, True)
        if kind == "col":
            xf = full(x)
            return Pieces(self._product(t, layer, xf, member, True) for t in range(tp))
        if kind == "row":
            pieces = x if isinstance(x, Pieces) else full(x).chunk(tp, -1)
            acc = self._product(0, layer, pieces[0], member, False)
            for t in range(1, tp):
                acc = acc + self._product(t, layer, pieces[t], member, False)
            return acc + self._shared_bias(layer, member)
        if member is not None:
            raise NotImplementedError("member= on a member-parallel stack")
        m = self.num_members // tp
        own_bias = tp_dim(self.specs[f"{layer}.bias"]) == 0
        out = Members()
        for t in range(tp):
            xt = x[t] if isinstance(x, Members) else (
                full(x)[t * m:(t + 1) * m] if stacked_act else full(x))
            rows = None if own_bias else slice(t * m, (t + 1) * m)
            out.append(self._product(t, layer, xt, None, own_bias, rows))
        return out

    def forward(self, obs: torch.Tensor, action: torch.Tensor | None = None,
                member: int | None = None) -> torch.Tensor:
        lane0 = self.lanes[0]
        dt = self.compute_dtype
        x = obs
        stacked_act = False
        if self.pixels:
            if self.stacked:
                x = lane0.PixelEncoder_0(obs, member)
                stacked_act = member is None
            else:
                x = lane0.PixelEncoder_0(obs)
        for i in range(self.num_hidden):
            layer = f"hidden_{i}"
            x = _map(torch.relu, self._apply(layer, x, member, stacked_act))
            stacked_act = stacked_act or (self.stacked and member is None)
            if self.is_critic and i == 0:
                x = _concat(x, action.to(dt))
        y = full(self._apply("out", x, member, stacked_act))
        return y.float() if self.is_critic else torch.tanh(y).float()

    # ---------------------------------------------------- gather / shard
    def gather_module(self) -> nn.Module:
        """The whole network (a new module on the lanes' device): every
        parameter gathered from its lanes' shards."""
        whole = copy.deepcopy(self.lanes[0])
        for name, p in self.lanes[0].named_parameters():
            g = self._gather[name](self.lane_params(name))
            _set_param(whole, name, nn.Parameter(g, requires_grad=p.requires_grad))
        return whole

    @torch.no_grad()
    def load_whole(self, whole: nn.Module) -> None:
        """Shard a whole network's parameters into the lanes, in place."""
        for name, p in whole.named_parameters():
            for dst, s in zip(self.lane_params(name), self._shard[name](p)):
                dst.copy_(s)


def _concat(x, a: torch.Tensor):
    """The critic's ``[h, action]`` concat: per member block, or on the
    whole activation (a split one gathered first)."""
    def cat(h):
        return torch.cat([h, a.expand(h.shape[:-1] + a.shape[-1:])], dim=-1)

    return Members(cat(h) for h in x) if isinstance(x, Members) else cat(full(x))


def _opt_like(opt: torch.optim.Optimizer, params) -> torch.optim.Optimizer:
    return type(opt)(params, **opt.defaults)


def _copy_into_state(opt_state, param, new: dict) -> None:
    """Set a parameter's Adam state to ``new``. Tensors it holds already,
    of the same shape and device, take the values by ``copy_`` and stay
    the tensors they were: a captured program reads them by address."""
    old = opt_state.get(param)
    if old and old.keys() == new.keys() and all(
            old[k].shape == v.shape and old[k].device == v.device for k, v in new.items()):
        for k, v in new.items():
            old[k].copy_(v)
    else:
        opt_state[param] = new


def _clone_gen(gen):
    if gen is None:
        return None
    out = torch.Generator(gen.device)
    out.set_state(gen.get_state())
    return out


class TPTrainState(TrainState):
    """A train state sharded over ``mesh.tp`` lanes (module docstring).
    Built by :func:`~d4pg_tpu_torch.parallel.partition.shard_train_state`
    from a whole state, which it leaves as it is."""

    def __init__(self, whole: TrainState, mesh, specs: dict):
        tp = int(mesh.shape["tp"])
        nets = {name: TPModule(getattr(whole, name), specs[name], tp) for name in NETWORKS}
        super().__init__(
            nets["actor"], nets["critic"], nets["target_actor"], nets["target_critic"],
            _opt_like(whole.actor_opt, nets["actor"].parameters()),
            _opt_like(whole.critic_opt, nets["critic"].parameters()),
            stack=whole.stack, subset_gen=_clone_gen(whole.subset_gen), head=whole.head,
            augment_gen=_clone_gen(whole.augment_gen),
        )
        self.tp = tp
        self.specs = specs
        self.step = whole.step
        self._load_moments(whole)

    def _pairs(self, whole: TrainState):
        """(TP module, TP optimizer, whole module, whole optimizer) of the
        actor and the critic."""
        return ((self.actor, self.actor_opt, whole.actor, whole.actor_opt),
                (self.critic, self.critic_opt, whole.critic, whole.critic_opt))

    def _load_moments(self, whole: TrainState) -> None:
        for tpm, opt, wm, wopt in self._pairs(whole):
            for name, p in wm.named_parameters():
                lanes = tpm.lane_params(name)
                st = wopt.state.get(p)
                if not st:
                    for q in lanes:
                        opt.state.pop(q, None)
                    continue
                moments = {k: tpm._shard[name](st[k]) for k in ("exp_avg", "exp_avg_sq")}
                for t, q in enumerate(lanes):
                    new = {"step": st["step"].clone(), **{k: v[t] for k, v in moments.items()}}
                    _copy_into_state(opt.state, q, new)

    def whole(self) -> TrainState:
        """The whole state: every network, Adam moment and counter
        gathered (new tensors; the generators are this state's own)."""
        nets = {name: getattr(self, name).gather_module() for name in NETWORKS}
        out = TrainState(
            nets["actor"], nets["critic"], nets["target_actor"], nets["target_critic"],
            _opt_like(self.actor_opt, nets["actor"].parameters()),
            _opt_like(self.critic_opt, nets["critic"].parameters()),
            stack=self.stack, subset_gen=self.subset_gen, head=self.head,
            augment_gen=self.augment_gen,
        )
        out.step = self.step
        for tpm, opt, wm, wopt in self._pairs(out):
            for name, p in wm.named_parameters():
                lanes = tpm.lane_params(name)
                st = [opt.state.get(q) for q in lanes]
                if not st[0]:
                    continue
                wopt.state[p] = {"step": st[0]["step"].clone(),
                                 **{k: tpm._gather[name]([s[k] for s in st])
                                    for k in ("exp_avg", "exp_avg_sq")}}
        return out

    def load_whole(self, whole: TrainState) -> None:
        """Shard a whole state (a restored checkpoint) into this one, in
        place: networks, Adam moments, the step and the generators."""
        for name in NETWORKS:
            getattr(self, name).load_whole(getattr(whole, name))
        self._load_moments(whole)
        self.step = whole.step
        for attr in ("subset_gen", "augment_gen"):
            mine, theirs = getattr(self, attr), getattr(whole, attr)
            if mine is not None and theirs is not None and mine is not theirs:
                mine.set_state(theirs.get_state())
