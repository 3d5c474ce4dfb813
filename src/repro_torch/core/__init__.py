"""CAPre's static analysis on the port: the access plan of a step
(``access_plan``), and the compile-time analysis of an object-oriented
application, each module the twin of the JAX package's of the same name:
the AST (``lang``), the IR (``ir``) and its lowering (``lower``), the
augmented type graph (``type_graph``), hint generation and caller dedup
(``hints``), the static optimizer (``opt``), the ROP baseline (``rop``),
the generated prefetch methods (``injection``), the random app corpus
(``corpus``) and the ``capre-lint`` verifier with its golden (``lint``)."""
