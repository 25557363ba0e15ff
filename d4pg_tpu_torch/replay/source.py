"""The fleet's part of the data plane's capability seam (the port's copy of
what the collection fleet needs from ``d4pg_tpu/replay/source.py``).

Two negotiations live here, each code once in the port:

- :func:`negotiate_source`: the verdicts of a training configuration on
  its experience source (the JAX ``negotiate``'s fleet codes, in its words
  and order): ``fleet_bundle_requires_listen``,
  ``obs_norm_fleet_single_writer``, ``fleet_only_async_collect``,
  ``fleet_wire_bf16_flat_only``, ``fleet_wire_requires_listen``,
  ``unknown_fleet_wire``, ``no_collection_source`` (``--num-envs 0``
  with nothing else to collect) and ``on_device_fleet``.
  ``config.check_fleet`` raises them; the other verdicts of the JAX
  table are ``config.py``'s ``check_placement``, ``check_on_device`` and
  ``check_collection``.
- :func:`learner_fleet_caps` / :func:`negotiate_fleet`: the HELLO
  handshake's capability vector. The learner states what its replay
  needs (the obs wire mode f32, u8 or bf16, actor-side HER, generation-
  tagged obs-norm statistics, its league variant), the actor what it can
  produce, and a mismatch is refused with structured reasons the actor
  can print, never streamed as a wrong distribution.

Stdlib only: the CLI validates with it before any heavy import, and the
fleet's ingest server imports it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

# The fleet wire's obs encodings (fleet/wire.py holds the codecs):
#   f32  — 4 bytes an element, the in-process writer's bytes;
#   u8   — 1 byte an element: pixel rows quantized as the uint8 replay
#          quantizes them (rint(obs·255)), so the stored bytes match;
#   bf16 — 2 bytes an element: flat rows rounded to bfloat16, the one
#          mode whose content differs from local collection, by design.
OBS_MODES = ("f32", "u8", "bf16")


@dataclass(frozen=True)
class CapabilityGap:
    """One declared gap: ``code`` the stable machine-readable reason,
    ``message`` the refusal's words."""

    code: str
    message: str


@dataclass(frozen=True)
class Negotiation:
    """The outcome of negotiating one composition: ``pass``, or ``gap``
    with its gaps."""

    verdict: str                              # "pass" | "gap"
    gaps: Tuple[CapabilityGap, ...] = ()      # non-empty iff verdict == "gap"

    @property
    def ok(self) -> bool:
        return self.verdict != "gap"


@dataclass(frozen=True)
class RequestedCaps:
    """What one training configuration asks of its experience source: the
    fields of the JAX dataclass that the fleet's verdicts and the HELLO's
    learner half read, under their names."""

    pixel: bool = False
    obs_norm: bool = False
    her: bool = False
    fleet: bool = False
    fleet_only: bool = False
    fleet_bundle: bool = False
    fleet_wire: str = "auto"        # auto | float32 | bfloat16
    on_device: bool = False
    async_collect: bool = False
    num_envs: int = 1
    # the league variant this learner is (0 = none); the HELLO negotiates
    # it, so an actor assigned elsewhere never feeds this replay
    variant: int = 0


def from_train_config(config, *, on_device: bool = False) -> RequestedCaps:
    """A port ``TrainConfig`` in the capability vocabulary."""
    return RequestedCaps(
        pixel=bool(config.agent.pixel_shape),
        obs_norm=bool(config.obs_norm),
        her=bool(config.her),
        fleet=config.fleet_listen is not None,
        fleet_only=config.fleet_listen is not None and config.num_envs == 0,
        fleet_bundle=bool(config.fleet_bundle),
        fleet_wire=config.fleet_wire_dtype,
        on_device=on_device,
        async_collect=bool(config.async_collect),
        num_envs=int(config.num_envs),
        variant=int(config.variant_id or 0),
    )


def negotiate_source(caps: RequestedCaps) -> Negotiation:
    """The fleet's and the collection source's verdict on a request: its
    gaps in the JAX ``negotiate``'s words and order, or a pass."""
    gaps: List[CapabilityGap] = []

    def gap(code: str, message: str) -> None:
        gaps.append(CapabilityGap(code, message))

    if caps.fleet_bundle and not caps.fleet:
        gap(
            "fleet_bundle_requires_listen",
            "--fleet-bundle does nothing without --fleet-listen: the "
            "bundle is published at ingest generation bumps (use "
            "--export-bundle for a one-shot export)",
        )
    if caps.fleet:
        if caps.obs_norm and not caps.fleet_only:
            # one statistics writer: the ingest's writer thread folds per
            # ingested window, and local collection would fold per acted
            # step beside it
            gap(
                "obs_norm_fleet_single_writer",
                "--fleet-listen with --obs-norm requires --num-envs 0 "
                "(fleet-only): normalizer statistics fold at exactly one "
                "boundary — the ingest writer — and concurrent local "
                "collection would race the Welford merge",
            )
        if caps.fleet_only and caps.async_collect:
            gap(
                "fleet_only_async_collect",
                "--async-collect needs local envs; with --num-envs 0 "
                "the fleet is the only collector (drop --async-collect)",
            )
        if caps.fleet_wire == "bfloat16" and caps.pixel:
            gap(
                "fleet_wire_bf16_flat_only",
                "--fleet-wire-dtype bfloat16 compresses FLAT rows; pixel "
                "rows already stream u8-quantized at 1/4 the f32 bytes",
            )
    elif caps.fleet_wire not in ("auto", "float32"):
        gap(
            "fleet_wire_requires_listen",
            "--fleet-wire-dtype shapes the fleet ingest wire; it does "
            "nothing without --fleet-listen",
        )
    if caps.fleet_wire not in ("auto", "float32", "bfloat16"):
        gap(
            "unknown_fleet_wire",
            "fleet_wire_dtype must be auto|float32|bfloat16, got "
            f"{caps.fleet_wire!r}",
        )
    if caps.num_envs == 0 and not caps.fleet:
        gap(
            "no_collection_source",
            "--num-envs 0 means no local collection at all; it requires "
            "--fleet-listen so remote actor hosts supply the experience",
        )
    if caps.on_device and caps.fleet:
        gap(
            "on_device_fleet",
            "--fleet-listen feeds the HOST replay buffer; --on-device "
            "keeps replay inside one XLA program (the flag would be "
            "silently ignored)",
        )
    return Negotiation("gap", tuple(gaps)) if gaps else Negotiation("pass")


# ------------------------------------------------------------ fleet HELLO
# What a HELLO without "caps" declares: the v1 wire, f32 windows, no HER,
# no stats tags, variant 0 (so it feeds a default learner and is refused
# by a league variant's), and the collection fleet as its source.
LEGACY_ACTOR_CAPS = {
    "wire": 1,
    "obs_modes": ["f32"],
    "her": False,
    "obs_norm": False,
    "variant": 0,
    "source": "actor",
}


def learner_fleet_caps(caps: RequestedCaps) -> dict:
    """What the learner's replay needs of fleet actors: the server half of
    the HELLO capability vector."""
    if caps.pixel:
        obs_mode = "u8"      # pixel rows stream as the replay's own bytes
    elif caps.fleet_wire == "bfloat16":
        obs_mode = "bf16"
    else:
        obs_mode = "f32"
    return {
        "obs_mode": obs_mode,
        "her": caps.her,
        "obs_norm": caps.obs_norm,
        "variant": int(caps.variant),
    }


def negotiate_fleet(learner: dict, actor: dict
                    ) -> Tuple[Optional[dict], Tuple[CapabilityGap, ...]]:
    """One actor connection against the learner's needs → ``(chosen,
    gaps)``: the capability set the connection speaks (None when refused)
    and the structured reasons of a refusal, which the ingest ships back
    as JSON."""
    gaps: List[CapabilityGap] = []
    modes = tuple(actor.get("obs_modes") or ("f32",))
    want_mode = learner["obs_mode"]
    if want_mode not in modes:
        gaps.append(CapabilityGap(
            "obs_mode_unsupported",
            f"learner streams obs as {want_mode!r}, actor supports "
            f"{list(modes)} (upgrade the actor host: WINDOWS2 frames)",
        ))
    actor_her = bool(actor.get("her", False))
    if learner["her"] and not actor_her:
        gaps.append(CapabilityGap(
            "her_required",
            "learner trains on hindsight-relabeled windows; this actor "
            "does not relabel (run it with --her)",
        ))
    elif actor_her and not learner["her"]:
        gaps.append(CapabilityGap(
            "her_unexpected",
            "actor ships hindsight-relabeled windows but the learner "
            "did not ask for HER (drop the actor's --her)",
        ))
    learner_variant = int(learner.get("variant", 0))
    actor_variant = int(actor.get("variant", 0))
    if learner_variant != actor_variant:
        # an exact match: another variant's windows would train this
        # population member on another policy's experience
        gaps.append(CapabilityGap(
            "variant_mismatch",
            f"learner is league variant {learner_variant}, actor is "
            f"assigned variant {actor_variant} (re-point the actor host "
            "at its assigned variant's ingest port)",
        ))
    actor_norm = bool(actor.get("obs_norm", False))
    if learner["obs_norm"] and not actor_norm:
        gaps.append(CapabilityGap(
            "obs_norm_required",
            "learner normalizes observations; this actor does not apply "
            "the bundle's generation-tagged stats (upgrade the actor "
            "host / re-point it at the published bundle)",
        ))
    elif actor_norm and not learner["obs_norm"]:
        gaps.append(CapabilityGap(
            "obs_norm_unexpected",
            "actor acts on normalized observations but the learner "
            "publishes no statistics (bundle/learner config skew)",
        ))
    if gaps:
        return None, tuple(gaps)
    return (
        {
            "obs_mode": want_mode,
            "her": learner["her"],
            "obs_norm": learner["obs_norm"],
            "variant": learner_variant,
            # passed through: it picks the ingest's per-source counter
            "source": str(actor.get("source", "actor")),
        },
        (),
    )
