"""The paper's experiments on the port (Fig.1, Fig.6)."""
