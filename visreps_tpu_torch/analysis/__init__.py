"""Analysis protocols: RSA layer selection and the train/test RSA
protocol, stimulus and concept alignment, and the encoding score."""
