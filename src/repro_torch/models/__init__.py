"""The LM substrate's models, ported from the JAX package's ``models/``:
the dense family (``transformer``, ``attention``, ``mlp``, ``layers``),
``model_zoo.build`` and the weights bridge ``convert.from_jax_params``."""
