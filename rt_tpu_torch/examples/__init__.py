"""The JAX package's examples, ported: ``python -m
rt_tpu_torch.examples.inverse_rendering`` and ``python -m
rt_tpu_torch.examples.big_scene_training`` (each takes ``--device``, default
``cuda``, in place of the JAX examples' ``--cpu``), and ``python -m
rt_tpu_torch.examples.sharded_render`` (one rank per card, or ``--virtual N``
ranks on the CPU)."""
