"""The reference's distribution layer on ``torch.distributed``: the
sharding policy and its specs (``sharding``), the decode cache's specs
(``staterules``), expert-parallel MoE (``ep_moe``) and the DTensor
version shim (``compat``)."""
