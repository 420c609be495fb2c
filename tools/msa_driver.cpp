// Headless driver for the *reference* MSA stereo solver
// (/root/reference/Thirdparty/MB/MSA.cpp — built unmodified from the
// reference tree; this file is original and only drives it).
//
// Purpose: generate golden disparity maps from the reference's actual
// disparity engine so tests/test_real_images.py can quantify how close the
// SGM engine (stereo_semantic_vo_tpu/ops/dense_stereo.py) comes
// to MSA::solve (MSA.cpp:1132-1169) on the reference's vendored fixtures.
//
// Usage: msa_ref <left> <right> <ndisp> <scale> <out.pgm>
//   out.pgm holds MSA's uchar output = disparity * scale (MSA.cpp:1107-1124).
//
// MSA::output calls cv::imshow unconditionally (MSA.cpp:1118), which aborts
// without a display; the executable-level definition below interposes the
// highgui symbol at static link time, turning it into a no-op.

#include <chrono>
#include <cstdio>
#include <opencv2/opencv.hpp>
#include "MSA.h"

namespace cv {
void imshow(const String&, InputArray) {}  // headless stub (link-time interpose)
}  // namespace cv

static MSA solver;  // ~1 GB of static arrays (MSA.h:4 N=2e6) — keep global

int main(int argc, char** argv) {
    if (argc != 6) {
        std::fprintf(stderr, "usage: %s left right ndisp scale out.pgm\n", argv[0]);
        return 2;
    }
    cv::Mat left = cv::imread(argv[1]);
    cv::Mat right = cv::imread(argv[2]);
    if (left.empty() || right.empty()) {
        std::fprintf(stderr, "failed to read images\n");
        return 1;
    }
    int ndisp = std::atoi(argv[3]);
    int scale = std::atoi(argv[4]);
    auto t0 = std::chrono::steady_clock::now();
    cv::Mat disp = solver.solve(left, right, ndisp, scale, false);
    auto t1 = std::chrono::steady_clock::now();
    std::printf("solve_ms %.1f\n",
                std::chrono::duration<double, std::milli>(t1 - t0).count());
    if (!cv::imwrite(argv[5], disp)) {
        std::fprintf(stderr, "failed to write %s\n", argv[5]);
        return 1;
    }
    std::printf("wrote %s (%dx%d)\n", argv[5], disp.cols, disp.rows);
    return 0;
}
