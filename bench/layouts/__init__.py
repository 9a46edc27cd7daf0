"""Layouts: what the harness knows of one family of architectures.

A configuration file names its layout with a ``"layout"`` key beside
``"reference"``: a path from the checkout's root
(``bench/layouts/<family>.py``) or an absolute one; without the key it is
:mod:`bench.layouts.decoder`.  A layout imports nothing of the program
(``repro_torch``) and nothing of JAX.
For a configuration's ``run`` it gives:

- ``leaf_specs(run)``: every weight as ``(path, shape, std)``, in draw order.
  A path under ``("segments", "<i>", ...)`` becomes entry ``i`` of the
  tree's ``segments`` list (``bench.lib.weights.draw``).
- ``step_products(run, batch, tokens, checked)``: the dense ``matmul_abft``
  launches of one step as ``(M, K, N, checked)``, the head included.
- ``expert_products(run, batch, tokens)``: the grouped launches as
  ``(rows, K, N, live experts)``.
- ``flash_launches(run, batch, prompt, checked)``: the ``flash_checksum``
  launches of one prefill as ``(b, t, s, h, kh, dk, dv)``.
- ``weights_per_token(run)``: the weights one token multiplies by in one
  pass through the layers, without the head.
- ``pair_flops(run)``: attention's model FLOPs per query-key pair, one entry
  a layer.

``bench.lib.arith`` sums the kernel bounds and the model FLOPs over these.
"""
