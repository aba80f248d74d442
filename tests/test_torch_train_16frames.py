"""One AgentOE train step of the port at 16 frames against lrce_tpu's agent,
on the CPU at f32 (tests/test_torch_train.py's tiny configuration and
limits: the loss to 1e-4 relative, every decided parameter within 0.02 x lr
of lrce_tpu's update).

At 16 frames the window (8, 7, 7) is not clamped: N = 392 at every stage of
the 224 x 224 clips, the relative-position index used unsliced, the route
that K4's rows / columns pair takes on the card (on the CPU the kernels'
plain versions inside the same autograd.Functions). One question of 3
clips: the 5-frame step's two would double its ~2 min here. A file of its
own, so that a parallel run gives it its own worker.
"""

from tests.test_torch_train import agent_oe_step_matches_jax


def test_agent_oe_train_step_matches_jax_at_16_frames():
    agent_oe_step_matches_jax(16, 1)
