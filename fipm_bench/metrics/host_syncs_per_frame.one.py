"""Host waits and copies (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaMemcpyAsync) of the traced window per frame."""
from fipm_bench.readers import host_syncs_per_frame as read  # noqa: F401
