"""Each model family's side of the harness, found by the ``family`` that a
configuration file names (``benchlib/spec.py``). A module ``<family>.py``
here may import the port, inside its functions, and provides:

- ``port_config(cfg)``: the port's configuration built from the file's
  own sizes, and ``mismatches(cfg, port_cfg)``: each size of the file that
  the port's configuration does not hold;
- ``dims(cfg)`` and ``leaf_plan(cfg)``: the sizes, and the plan of the
  tree the port and the reference both take, which ``weights.make`` draws
  from the seed;
- ``eval_model(cfg, spec, params, device)``: the port's model for
  evaluation, with its ``engine`` and ``pack_cfg``;
- ``pack_config(spec, port_cfg)`` and ``train_loss()``: what
  ``make_train_step`` and the batches of a train step take;
- ``samples(traffic, batch)``: raw requests as the port's ``ICLSample``s,
  the prompt built by the port's own builder;
- ``eval_work(cfg, work, clip_samples, prompts, new_tokens)`` and
  ``train_work(cfg, work, clip_samples, positions)``: the work of an eval
  batch and of a train step (``benchlib/work.py``);
- ``OPS``: operations the family adds to ``opmap.json``, each with its
  kernel patterns; it may not name one that the file has.
"""
