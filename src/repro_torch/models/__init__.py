"""The models, ported from the JAX package's ``models/``: the LM substrate's
dense, ssm and hybrid families (``transformer``, ``attention``, ``mlp``,
``ssm``: the Mamba2 block, ``layers``), the solver family (``solver_layer``: the differentiable solve as a layer),
``model_zoo.build`` and the weights bridge ``convert``."""
