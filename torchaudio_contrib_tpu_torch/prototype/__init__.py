"""``torchaudio.prototype``-shaped namespace.

The port of the JAX package's ``prototype``: the prototype-surface names
this package implements, re-exported at their torchaudio import paths,
with the JAX package's name lists.  All objects are the same as the flat
package exports.
"""

from . import functional, models, pipelines, transforms

__all__ = ["functional", "models", "pipelines", "transforms"]
