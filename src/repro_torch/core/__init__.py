"""The port's copy of the Zerrow core that the relational ops need.

``arrow`` (columns, batches, tables), ``vkernels`` (numpy bulk kernels,
the reference semantics), ``kdispatch`` (the numpy <-> tensor edge that
routes key hashing, join gathers and integer segment reductions to the
hand-written CUDA kernels) and ``ops`` (table transformations, among them
``join``, ``filter_join`` and ``group_by``), each a copy of its
counterpart in the JAX package's ``core/``.
"""
