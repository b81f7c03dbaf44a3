"""Launchers of the port's LM stack (the serving and training steps and
loops, the ranks' bring-up) and its tooling: the H100's roofline, the cost
count, the tuned launches and the dry run."""
