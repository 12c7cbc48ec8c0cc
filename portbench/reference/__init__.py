"""Plain float32 models, one module a configuration's ``reference``: each has
``params(model sizes)`` and ``logits(model sizes, weights, tokens, precision)``."""
