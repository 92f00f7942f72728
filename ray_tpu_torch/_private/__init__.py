"""Internals of the port shared by its planes: the g++ build of its host
C++ (``native_build``), pickling (``serialization``) and the configuration
table (``config``), the counterparts of ``ray_tpu/_private``'s modules of
those names."""
