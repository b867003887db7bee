"""Media readers and writers (WAV, Y4M, MJPEG-AVI, JPEG; the libav
containers through their shim) and synthetic clips. The names below are the
JAX package's `hippomm_tpu.media` exports."""

from hippomm_tpu_torch.media.io import (  # noqa: F401
    AviReader,
    VideoInfo,
    Y4MReader,
    jpeg_decode,
    jpeg_encode,
    load_audio_mono16k,
    native_available,
    open_video,
    probe_video,
    read_frames_at_times,
    read_jpeg,
    read_wav,
    sample_indices_at_fps,
    write_avi,
    write_jpeg,
    write_wav,
    write_y4m,
)
