"""The JAX package's single-process examples, ported: ``python -m
rt_tpu_torch.examples.inverse_rendering`` and ``python -m
rt_tpu_torch.examples.big_scene_training`` (each takes ``--device``, default
``cuda``, in place of the JAX examples' ``--cpu``)."""
