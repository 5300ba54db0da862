// Native runtime components: JPEG decode (libjpeg) and V4L2 webcam capture.
//
// The PyTorch port's own copy of native/zaru_native.cpp: the counterpart of
// the reference's native I/O, the multi-backend JPEG decoders (reference
// crates/zaru-image/src/jpeg.rs) and the V4L2 MJPEG capture path
// (crates/zaru/src/video/webcam.rs, via the linuxvideo crate). Exposed as a
// plain C ABI consumed through ctypes (zaru_tpu_torch/native/__init__.py),
// built on the host with g++ (no CUDA).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>

#include <fcntl.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <jpeglib.h>
#include <linux/videodev2.h>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG decoding
// ---------------------------------------------------------------------------

struct ZjErrorMgr {
    jpeg_error_mgr pub_;
    jmp_buf jmp;
    char msg[JMSG_LENGTH_MAX];
};

static void zj_error_exit(j_common_ptr cinfo) {
    ZjErrorMgr* err = reinterpret_cast<ZjErrorMgr*>(cinfo->err);
    (*cinfo->err->format_message)(cinfo, err->msg);
    longjmp(err->jmp, 1);
}

// Parses JPEG header only; returns 0 on success and fills w/h.
int zj_jpeg_size(const uint8_t* data, size_t len, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    ZjErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub_);
    jerr.pub_.error_exit = zj_error_exit;
    if (setjmp(jerr.jmp)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decodes a baseline/progressive JPEG into caller-provided RGB888 buffer of
// size w*h*3 (use zj_jpeg_size first). Returns 0 on success, -1 on error
// (error message written to errbuf if non-null).
int zj_jpeg_decode(const uint8_t* data, size_t len, uint8_t* out, int out_w,
                   int out_h, char* errbuf, size_t errbuf_len) {
    jpeg_decompress_struct cinfo;
    ZjErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub_);
    jerr.pub_.error_exit = zj_error_exit;
    if (setjmp(jerr.jmp)) {
        if (errbuf && errbuf_len) {
            strncpy(errbuf, jerr.msg, errbuf_len - 1);
            errbuf[errbuf_len - 1] = 0;
        }
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if ((int)cinfo.output_width != out_w || (int)cinfo.output_height != out_h ||
        cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        if (errbuf && errbuf_len) snprintf(errbuf, errbuf_len, "size mismatch");
        return -1;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = out + (size_t)cinfo.output_scanline * out_w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// ---------------------------------------------------------------------------
// V4L2 capture
// ---------------------------------------------------------------------------

constexpr int kMaxBuffers = 4;

struct ZjCam {
    int fd = -1;
    void* buffers[kMaxBuffers] = {};
    size_t buf_len[kMaxBuffers] = {};
    int n_buffers = 0;
    bool streaming = false;
};

static int xioctl(int fd, unsigned long req, void* arg) {
    int r;
    do {
        r = ioctl(fd, req, arg);
    } while (r == -1 && errno == EINTR);
    return r;
}

// Queries the device's card name into `name` (size n). Returns 0 on success,
// -1 if the path is not a capture device.
int zj_cam_query(const char* path, char* name, size_t n, uint32_t* caps) {
    int fd = open(path, O_RDWR | O_NONBLOCK);
    if (fd < 0) return -1;
    v4l2_capability cap = {};
    if (xioctl(fd, VIDIOC_QUERYCAP, &cap) != 0) {
        close(fd);
        return -1;
    }
    if (name && n) {
        strncpy(name, reinterpret_cast<const char*>(cap.card), n - 1);
        name[n - 1] = 0;
    }
    if (caps) *caps = cap.device_caps ? cap.device_caps : cap.capabilities;
    close(fd);
    return 0;
}

// Emits every discrete frame interval for (pixfmt, w, h); if the driver
// reports stepwise/continuous intervals (or none), emits one 30 fps
// entry so the mode is still negotiable. Returns the updated count.
static int zj_emit_size(int fd, uint32_t pixfmt, uint32_t w, uint32_t h,
                        uint32_t* out, int cap_entries, int count) {
    bool any = false;
    for (uint32_t ii = 0;; ii++) {
        v4l2_frmivalenum fiv = {};
        fiv.index = ii;
        fiv.pixel_format = pixfmt;
        fiv.width = w;
        fiv.height = h;
        if (xioctl(fd, VIDIOC_ENUM_FRAMEINTERVALS, &fiv) != 0) break;
        if (fiv.type != V4L2_FRMIVAL_TYPE_DISCRETE) break;
        any = true;
        if (count < cap_entries) {
            out[count * 5 + 0] = pixfmt;
            out[count * 5 + 1] = w;
            out[count * 5 + 2] = h;
            // fps = denominator/numerator of the frame *interval*.
            out[count * 5 + 3] = fiv.discrete.denominator;
            out[count * 5 + 4] = fiv.discrete.numerator;
            count++;
        }
    }
    if (!any && count < cap_entries) {
        out[count * 5 + 0] = pixfmt;
        out[count * 5 + 1] = w;
        out[count * 5 + 2] = h;
        out[count * 5 + 3] = 30;
        out[count * 5 + 4] = 1;
        count++;
    }
    return count;
}

// Enumerates (fourcc, width, height, fps_num, fps_den) tuples into `out`
// (5 uint32 each, capacity `cap_entries`). Returns count or -1.
int zj_cam_enum(const char* path, uint32_t* out, int cap_entries) {
    int fd = open(path, O_RDWR | O_NONBLOCK);
    if (fd < 0) return -1;
    int count = 0;
    for (uint32_t fi = 0;; fi++) {
        v4l2_fmtdesc fmt = {};
        fmt.index = fi;
        fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        if (xioctl(fd, VIDIOC_ENUM_FMT, &fmt) != 0) break;
        for (uint32_t si = 0;; si++) {
            v4l2_frmsizeenum fsz = {};
            fsz.index = si;
            fsz.pixel_format = fmt.pixelformat;
            if (xioctl(fd, VIDIOC_ENUM_FRAMESIZES, &fsz) != 0) break;
            if (fsz.type == V4L2_FRMSIZE_TYPE_DISCRETE) {
                count = zj_emit_size(fd, fmt.pixelformat, fsz.discrete.width,
                                     fsz.discrete.height, out, cap_entries,
                                     count);
                continue;
            }
            // STEPWISE/CONTINUOUS ranges (ISP/codec drivers): emit the
            // min and max sizes so the device still negotiates instead
            // of enumerating zero modes. (Index 0 describes the whole
            // range; there is no index 1.)
            count = zj_emit_size(fd, fmt.pixelformat, fsz.stepwise.min_width,
                                 fsz.stepwise.min_height, out, cap_entries,
                                 count);
            count = zj_emit_size(fd, fmt.pixelformat, fsz.stepwise.max_width,
                                 fsz.stepwise.max_height, out, cap_entries,
                                 count);
            break;
        }
    }
    close(fd);
    return count;
}

// Opens + configures + starts streaming. Returns a handle or null.
ZjCam* zj_cam_open(const char* path, uint32_t fourcc, uint32_t width,
                   uint32_t height, uint32_t fps_num, uint32_t fps_den) {
    int fd = open(path, O_RDWR);
    if (fd < 0) return nullptr;

    v4l2_format fmt = {};
    fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    fmt.fmt.pix.pixelformat = fourcc;
    fmt.fmt.pix.width = width;
    fmt.fmt.pix.height = height;
    fmt.fmt.pix.field = V4L2_FIELD_ANY;
    if (xioctl(fd, VIDIOC_S_FMT, &fmt) != 0) {
        close(fd);
        return nullptr;
    }
    // Drivers ADJUST the format and return success rather than failing;
    // silently proceeding would hand non-JPEG bytes (or a different
    // resolution) to a caller that negotiated this exact mode.
    if (fmt.fmt.pix.pixelformat != fourcc || fmt.fmt.pix.width != width ||
        fmt.fmt.pix.height != height) {
        close(fd);
        return nullptr;
    }

    if (fps_num && fps_den) {
        v4l2_streamparm parm = {};
        parm.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        parm.parm.capture.timeperframe.numerator = fps_den;
        parm.parm.capture.timeperframe.denominator = fps_num;
        xioctl(fd, VIDIOC_S_PARM, &parm);  // best effort
    }

    v4l2_requestbuffers req = {};
    req.count = kMaxBuffers;
    req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    req.memory = V4L2_MEMORY_MMAP;
    if (xioctl(fd, VIDIOC_REQBUFS, &req) != 0 || req.count < 1) {
        close(fd);
        return nullptr;
    }

    ZjCam* cam = new ZjCam();
    cam->fd = fd;
    // REQBUFS may GRANT more buffers than requested (videobuf2 raises
    // count to the driver minimum); clamp to our array capacity — using
    // a subset of the granted buffers is legal, writing past
    // buffers[kMaxBuffers] is heap corruption.
    cam->n_buffers =
        (int)(req.count > kMaxBuffers ? kMaxBuffers : req.count);
    for (int i = 0; i < cam->n_buffers; i++) {
        v4l2_buffer buf = {};
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        buf.memory = V4L2_MEMORY_MMAP;
        buf.index = i;
        if (xioctl(fd, VIDIOC_QUERYBUF, &buf) != 0) goto fail;
        cam->buf_len[i] = buf.length;
        cam->buffers[i] =
            mmap(nullptr, buf.length, PROT_READ | PROT_WRITE, MAP_SHARED, fd,
                 buf.m.offset);
        if (cam->buffers[i] == MAP_FAILED) goto fail;
        if (xioctl(fd, VIDIOC_QBUF, &buf) != 0) goto fail;
    }
    {
        v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        if (xioctl(fd, VIDIOC_STREAMON, &type) != 0) goto fail;
    }
    cam->streaming = true;
    return cam;

fail:
    for (int i = 0; i < cam->n_buffers; i++)
        if (cam->buffers[i] && cam->buffers[i] != MAP_FAILED)
            munmap(cam->buffers[i], cam->buf_len[i]);
    close(fd);
    delete cam;
    return nullptr;
}

// Dequeues one frame into `out` (capacity `cap`). Returns byte count or -1.
long zj_cam_read(ZjCam* cam, uint8_t* out, size_t cap) {
    v4l2_buffer buf = {};
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    if (xioctl(cam->fd, VIDIOC_DQBUF, &buf) != 0) return -1;
    size_t n = buf.bytesused;
    if (n > cap) n = cap;
    memcpy(out, cam->buffers[buf.index], n);
    xioctl(cam->fd, VIDIOC_QBUF, &buf);
    return (long)n;
}

void zj_cam_close(ZjCam* cam) {
    if (!cam) return;
    if (cam->streaming) {
        v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        xioctl(cam->fd, VIDIOC_STREAMOFF, &type);
    }
    for (int i = 0; i < cam->n_buffers; i++)
        if (cam->buffers[i]) munmap(cam->buffers[i], cam->buf_len[i]);
    if (cam->fd >= 0) close(cam->fd);
    delete cam;
}

}  // extern "C"
