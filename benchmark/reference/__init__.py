"""The plain reference: the models' equations and AdamW in plain PyTorch,
independent of the port."""
