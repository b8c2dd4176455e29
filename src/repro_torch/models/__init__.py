"""The LM substrate of the port: layers, the MoE with its Sinkhorn router,
the decoder-only transformer and its serve step (attention families)."""
