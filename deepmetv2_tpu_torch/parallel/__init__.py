"""Mesh training and evaluation (the JAX package's ``parallel/``) over
``torch.distributed`` ranks: the mesh (``mesh.py``), process-group setup
(``multihost.py``), differentiable collectives (``collectives.py``), the
step context (``context.py``), the data-parallel steps of both families
(``dp.py``), and the edge-partitioned GraphMET step with its halo exchange
around the window-max kernels (``halo.py``, ``ep.py``)."""
