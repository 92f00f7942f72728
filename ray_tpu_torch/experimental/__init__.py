"""ray_tpu_torch.experimental: the internal KV API (``internal_kv``) and the
device-object transport (``device_objects``), the port of
``ray_tpu/experimental``'s."""
