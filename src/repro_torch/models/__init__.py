"""The models, ported from the JAX package's ``models/``: the LM substrate's
dense family (``transformer``, ``attention``, ``mlp``, ``layers``), the
solver family (``solver_layer``: the differentiable solve as a layer),
``model_zoo.build`` and the weights bridge ``convert``."""
