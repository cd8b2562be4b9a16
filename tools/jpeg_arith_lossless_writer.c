/* Writes arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEGs through
 * libjpeg-turbo 3.1.3, the library PIL 12.1.0 links
 * (PIL/../pillow.libs/libjpeg-*.so.62.4.0), which PIL's own save does not
 * ask for. Built by tools/make_image_formats.py (`arith_lossless_writer`)
 * with gcc against the system's jpeg62 headers (jpeglib.h), whose ABI the
 * library keeps; jpeg_enable_lossless, new in libjpeg-turbo 3.0, is
 * declared here.
 *
 *   writer IN.raw OUT.jpg WIDTH HEIGHT INPUT [option ...]
 *
 * IN.raw holds HEIGHT rows of WIDTH pixels of INPUT: gray (1 byte), rgb
 * (3) or cmyk (4). Options:
 *   arith            arithmetic coding (SOF9), sequential
 *   progressive      libjpeg's simple progression (SOF10 with arith)
 *   lossless=P,T     lossless (SOF3) with predictor P (1-7), point
 *                    transform T
 *   quality=Q        quantisation quality (default 90)
 *   space=S          the JPEG colour space: gray, ycc, rgb, cmyk or ycck
 *   sampling=HxV,... each component's sampling factors
 *   restart=N        a restart interval of N MCUs
 *   restart_rows=N   a restart interval of N MCU rows
 *   dc=TABLE,L,U     DC conditioning of arithmetic table TABLE (0-1)
 *   ac=TABLE,K       AC conditioning Kx of arithmetic table TABLE (0-1)
 * Exit 0 on success; libjpeg's error message and exit 1 on failure.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                          int point_transform);

static J_COLOR_SPACE space_of(const char *s) {
    if (!strcmp(s, "gray")) return JCS_GRAYSCALE;
    if (!strcmp(s, "ycc")) return JCS_YCbCr;
    if (!strcmp(s, "rgb")) return JCS_RGB;
    if (!strcmp(s, "cmyk")) return JCS_CMYK;
    if (!strcmp(s, "ycck")) return JCS_YCCK;
    fprintf(stderr, "unknown colour space %s\n", s);
    exit(2);
}

int main(int argc, char **argv) {
    if (argc < 6) {
        fprintf(stderr, "usage: %s IN.raw OUT.jpg WIDTH HEIGHT INPUT [option ...]\n", argv[0]);
        return 2;
    }
    const int w = atoi(argv[3]), h = atoi(argv[4]);
    struct jpeg_compress_struct cinfo;
    struct jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_compress(&cinfo);
    cinfo.image_width = w;
    cinfo.image_height = h;
    if (!strcmp(argv[5], "gray")) {
        cinfo.input_components = 1;
        cinfo.in_color_space = JCS_GRAYSCALE;
    } else if (!strcmp(argv[5], "rgb")) {
        cinfo.input_components = 3;
        cinfo.in_color_space = JCS_RGB;
    } else if (!strcmp(argv[5], "cmyk")) {
        cinfo.input_components = 4;
        cinfo.in_color_space = JCS_CMYK;
    } else {
        fprintf(stderr, "unknown input %s\n", argv[5]);
        return 2;
    }
    jpeg_set_defaults(&cinfo);
    /* the coding process first (jpeg_enable_lossless and
     * jpeg_simple_progression reset the colour space and the scans), then
     * the options that refine it */
    int quality = 90, progressive = 0, psv = 0, pt = 0;
    for (int i = 6; i < argc; ++i) {
        const char *a = argv[i];
        if (!strcmp(a, "arith")) {
            cinfo.arith_code = TRUE;
        } else if (!strcmp(a, "progressive")) {
            progressive = 1;
        } else if (!strncmp(a, "lossless=", 9)) {
            if (sscanf(a + 9, "%d,%d", &psv, &pt) != 2) return 2;
        } else if (!strncmp(a, "quality=", 8)) {
            quality = atoi(a + 8);
        }
    }
    jpeg_set_quality(&cinfo, quality, TRUE);
    if (psv) jpeg_enable_lossless(&cinfo, psv, pt);
    for (int i = 6; i < argc; ++i) {
        const char *a = argv[i];
        if (!strcmp(a, "arith") || !strcmp(a, "progressive") || !strncmp(a, "lossless=", 9) ||
            !strncmp(a, "quality=", 8)) {
            continue;
        } else if (!strncmp(a, "space=", 6)) {
            jpeg_set_colorspace(&cinfo, space_of(a + 6));
        } else if (!strncmp(a, "sampling=", 9)) {
            const char *p = a + 9;
            for (int c = 0; c < cinfo.num_components && *p; ++c) {
                int hs, vs, n = 0;
                if (sscanf(p, "%dx%d%n", &hs, &vs, &n) != 2) return 2;
                cinfo.comp_info[c].h_samp_factor = hs;
                cinfo.comp_info[c].v_samp_factor = vs;
                p += n;
                if (*p == ',') ++p;
            }
        } else if (!strncmp(a, "restart=", 8)) {
            cinfo.restart_interval = (unsigned int)atoi(a + 8);
        } else if (!strncmp(a, "restart_rows=", 13)) {
            cinfo.restart_in_rows = atoi(a + 13);
        } else if (!strncmp(a, "dc=", 3)) {
            int t, l, u;
            if (sscanf(a + 3, "%d,%d,%d", &t, &l, &u) != 3) return 2;
            cinfo.arith_dc_L[t] = (UINT8)l;
            cinfo.arith_dc_U[t] = (UINT8)u;
        } else if (!strncmp(a, "ac=", 3)) {
            int t, k;
            if (sscanf(a + 3, "%d,%d", &t, &k) != 2) return 2;
            cinfo.arith_ac_K[t] = (UINT8)k;
        } else {
            fprintf(stderr, "unknown option %s\n", a);
            return 2;
        }
    }
    if (progressive) jpeg_simple_progression(&cinfo);

    FILE *in = fopen(argv[1], "rb");
    if (!in) return 2;
    const size_t stride = (size_t)w * cinfo.input_components;
    unsigned char *pixels = malloc(stride * h);
    if (fread(pixels, 1, stride * h, in) != stride * h) return 2;
    fclose(in);
    FILE *out = fopen(argv[2], "wb");
    if (!out) return 2;
    jpeg_stdio_dest(&cinfo, out);
    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = pixels + stride * cinfo.next_scanline;
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    fclose(out);
    free(pixels);
    return 0;
}
