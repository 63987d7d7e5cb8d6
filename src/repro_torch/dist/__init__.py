"""Single-device counterparts of ``repro.dist``: embed, head and loss
(``sharding``), gradient compression (``compression``) and the boundary
exchange's cost model (``collectives``)."""
