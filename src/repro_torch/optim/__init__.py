"""The optimizer of the LM substrate (``adamw``), ported from the JAX
package's ``optim/``."""
