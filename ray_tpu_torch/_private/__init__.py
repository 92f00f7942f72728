"""Internals of the port: the runtime's single-node core (the GCS, the
raylet and its worker provisioning, the core worker, the shared-memory
object store, the RPC layer and its typed wire over a pure-Python msgpack),
pickling (``serialization``: the runtime's by-value pickler and the
checkpoint plane's blobs), the g++ build of the port's host C++
(``native_build``) and the configuration table (``config``).

Each module is the port of ``ray_tpu/_private``'s module of the same name,
with the JAX package's behaviour; the docstrings name where a port differs
(``msgpack`` has no counterpart there: it stands in for the third-party
package, which the card's machine lacks)."""
