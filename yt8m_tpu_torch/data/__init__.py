"""YT-8M input: TFRecord/proto codec, readers and the synthetic fixture
writer (numpy only; copies of the JAX package's codec)."""
