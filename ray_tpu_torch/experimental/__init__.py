"""ray_tpu_torch.experimental: the internal KV API (``internal_kv``), the
port of ``ray_tpu/experimental``'s. Device objects are not ported yet
(ROADMAP.md)."""
