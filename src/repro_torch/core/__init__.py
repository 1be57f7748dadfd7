"""Swan's choice ladder, interference monitor and controller: framework-free
copies of the JAX package's ``core/{cost,interference,controller}.py``."""
