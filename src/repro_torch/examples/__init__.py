"""The JAX package's examples on the port, each ``python -m
repro_torch.examples.<name> [--device cpu]``: ``quickstart`` (coupled
checkpoint/rollback and isolated evaluation), ``mcts_search`` (UCT over a
served session), ``rl_fanout`` (forked rollouts and a REINFORCE update)
and ``train_lm`` (training with a crash and a restart).  Each runs on the
card unless ``--device cpu`` is given, and exits 2 without a card and
without that flag."""
