"""Each model family's plain reference, found by the ``family`` that a
configuration file names (``benchlib/spec.py``). A module
``<family>.py`` here imports nothing of the port and provides:

- ``prompt_length(task, request, tok)`` → (positions, text tokens) of a
  request's prompt as the family builds it;
- ``Plain(cfg, tree)``: the family's plain model over the tree that
  ``weights.make`` drew from the harness side's ``leaf_plan``, which the
  drivers hand to ``reference/check.py`` (its docstring says what the
  object has).

The precisions belong to no family: ``reference/model.py``'s
``stated(cfg)`` and ``control(cfg)`` read only the file's ``quant``.
"""
