"""The collection fleet (the port's counterpart of ``d4pg_tpu/fleet``):
remote actor processes step envs with a NumPy policy and stream complete
n-step windows to the learner's replay over the policy server's framing
(``d4pg_tpu_torch/serve/protocol.py``).

- :mod:`d4pg_tpu_torch.fleet.wire`   — the payload codecs of the fleet
  frames (HELLO, HELLO_OK, the structured refusal, WINDOWS, WINDOWS2,
  WINDOWS_OK);
- :mod:`d4pg_tpu_torch.fleet.policy` — a serving bundle read and acted on
  with numpy alone;
- :mod:`d4pg_tpu_torch.fleet.ingest` — the learner's ingest server: a
  bounded queue with an explicit shed, generation-tagged stale drops and
  one writer thread into ``buffer.add_batch``;
- :mod:`d4pg_tpu_torch.fleet.actor`  — the actor host CLI
  (``python -m d4pg_tpu_torch.fleet.actor``).

No module here imports torch (nor does anything they import): an actor
host loads numpy and the stdlib only, and the learner builds its ingest
server before anything touches the card. ``tests/test_torch_fleet.py``
checks that in a fresh interpreter.
"""
