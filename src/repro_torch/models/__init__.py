"""The LM substrate of the port: layers, the MoE with its Sinkhorn router,
the RWKV-6 time-mix and the Mamba2 block, the decoder-only transformer of
every family, its train step and its serve step."""
