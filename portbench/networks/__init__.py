"""The networks the benchmark can hold the program to, one package each.

A configuration (``portbench/configs/<config>.json``) names its network
(``"network": "<name>"``), and `harness.load_cell` loads
``portbench/networks/<name>/`` by that name. A network package holds
everything that describes one network and exposes:

- ``MODELLED``: for each of the configuration's sections ``model``,
  ``port``, ``reference`` and ``control``, the keys it models, each with
  the values it models (a tuple) or ``None`` for any value; a
  configuration with any other key or value is refused when its cell
  loads;
- ``config_kwargs(model)``: the program's `Config` fields for the
  ``model`` section (the harness adds the traffic's, the seed's and the
  ``port`` flags);
- ``make_weights(model, seed, device)``: ``(params, state)`` made from the
  seed on the device, in the layout the program takes;
- ``Reference(model, **section)``, built from the ``reference`` or the
  ``control`` section, with ``train(params, state, batches, lr,
  weights_fn)`` and ``log_probs(params, state, points)``: the plain
  reference, which imports nothing of the program or of JAX;
- ``work(model, valid, padded, train, peak_flops)``: a step's or a served
  batch's model operations, and a dict of its kernels' least seconds by
  kernel family (``"knn"``, ...), which the roofline readers take from
  ``trace.Trace.bounds_s``.

A later network is a new package: it may import an accepted network's
modules and extend them, and never edits them.
"""
