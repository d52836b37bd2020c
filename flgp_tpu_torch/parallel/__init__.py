"""The multi-device layer on ``torch.distributed``: meshes of processes, the
n-sharded spectral stage and GPC tail, chain-sharded MCMC and
particle-sharded SMC."""
