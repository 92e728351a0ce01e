"""Input pipelines of the LM substrate (``synthetic``), ported from the JAX
package's ``data/``."""
