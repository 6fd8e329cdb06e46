"""Classical estimators — port of
``learningorchestra_tpu/toolkit/estimators/``.

The sklearn / Spark-MLlib surface the reference orchestrates (the
builder's LR/DT/RF/GB/NB whitelist and any ``sklearn.*`` class through
the model service).  The JAX package writes them in jax.numpy for XLA;
none is a Pallas kernel.  Here the dense parts run as stock PyTorch ops
on the estimator's device, and what the JAX package does on the host
stays numpy, copied line for line so the results are bit-identical:
quantile binning, greedy tree growth, bootstrap draws, gradient
boosting's f64 softmax gradients and kmeans++ seeding, each from
``np.random.default_rng(random_state)``.
"""
