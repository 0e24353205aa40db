"""Closed-loop evaluation: the batched centroidal Monte-Carlo push study
(`monte_carlo`) and its metrics (`metrics`), the full-physics rigid-body
plant (`physics`), the analysis figures (`plots`, which imports
matplotlib) and the standalone HTML motion preview (`preview`)."""
