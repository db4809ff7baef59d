"""Mesh training and evaluation (the JAX package's ``parallel/``) over
``torch.distributed`` ranks: the mesh (``mesh.py``), process-group setup
(``multihost.py``), differentiable collectives (``collectives.py``), the
step context (``context.py``), the data-parallel steps of both families
(``dp.py``), the edge-partitioned GraphMET step with its halo exchange
around the window-max kernels (``halo.py``, ``ep.py``), and the
node-sharded DRN with its distributed kNN builds (``dyn.py``,
``knn.py``)."""
