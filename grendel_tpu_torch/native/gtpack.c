/* Ground-truth tile-row packing for the multi-rank loop's host path.
 *
 * The port's own copy of the JAX package's packer
 * (grendel_tpu/native/gtpack.c, called at grendel_tpu/engine/trainer.py
 * :542-550), with the contract of parallel/division.py pack_gt_rows: each
 * device's owned tile rows of the batch's (3, H, W) uint8 images are
 * copied into its block of a (D, max_rows, 3, tile_h, W) buffer, every
 * byte outside the rows (padding slots, rows past the image bottom, a
 * missing image) zero. The slots (a device's tile-row positions) are
 * split over POSIX threads, so a single device's span (the multi-rank
 * loop packs only its own) is packed by all of them; each slot is copied
 * with memcpy and only its bytes past the rows are zeroed.
 *
 * Built by grendel_tpu_torch/native/__init__.py with cc and called
 * through ctypes, which releases the interpreter lock.
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

#define MAX_THREADS 64
/* a thread takes at least this many bytes of out: below it, starting the
 * thread costs more than it saves */
#define BYTES_PER_THREAD ((int64_t)1 << 19)

typedef struct {
    const uint8_t *const *images;  /* B pointers to (3, H, W), NULL: none */
    uint8_t *out;                  /* (D, max_rows, 3, tile_h, W) */
    const int32_t *division;       /* (D + 1,) tile-row boundaries */
    int32_t max_rows, tile_h, img_h, img_w, tiles_y;
    int64_t begin, end;            /* this thread's slots, d * max_rows + s */
} PackJob;

static void *pack_worker(void *arg)
{
    const PackJob *j = (const PackJob *)arg;
    const int64_t w = j->img_w;
    const int64_t plane = (int64_t)j->img_h * w;    /* an image channel */
    const int64_t slot_ch = (int64_t)j->tile_h * w; /* a slot's channel */

    for (int64_t i = j->begin; i < j->end; i++) {
        int32_t d = (int32_t)(i / j->max_rows), s = (int32_t)(i % j->max_rows);
        uint8_t *slot = j->out + i * 3 * slot_ch;
        int32_t row = j->division[d] + s;
        const uint8_t *img = NULL;
        int64_t y0 = 0, lines = 0;
        if (row < j->division[d + 1]) {
            img = j->images[row / j->tiles_y];
            y0 = (int64_t)(row % j->tiles_y) * j->tile_h;
            lines = j->img_h - y0 < j->tile_h ? j->img_h - y0 : j->tile_h;
        }
        if (!img || lines <= 0) {
            memset(slot, 0, (size_t)(3 * slot_ch));
            continue;
        }
        for (int c = 0; c < 3; c++) {
            memcpy(slot + c * slot_ch, img + c * plane + y0 * w,
                   (size_t)(lines * w));
            if (lines < j->tile_h)      /* below the image's bottom */
                memset(slot + c * slot_ch + lines * w, 0,
                       (size_t)((j->tile_h - lines) * w));
        }
    }
    return NULL;
}

/* Pack the rows of division[d]..division[d + 1] of each device d into
 * out, every byte of out written. The slots of all devices are split into
 * n_threads runs of consecutive slots (fewer where out holds less than
 * BYTES_PER_THREAD a thread), one a thread (the calling thread
 * takes the first; a run whose thread cannot start runs here too).
 * Returns 0. */
int gtn_pack_gt_rows(const uint8_t *const *images, uint8_t *out,
                     const int32_t *division, int32_t n_devices,
                     int32_t max_rows, int32_t tile_h, int32_t img_h,
                     int32_t img_w, int32_t n_threads)
{
    int32_t tiles_y = (img_h + tile_h - 1) / tile_h;
    int64_t slots = (int64_t)n_devices * max_rows;
    int64_t most = 1 + slots * 3 * tile_h * img_w / BYTES_PER_THREAD;
    if (n_threads > MAX_THREADS)
        n_threads = MAX_THREADS;
    if ((int64_t)n_threads > most)
        n_threads = (int32_t)most;
    if ((int64_t)n_threads > slots)
        n_threads = (int32_t)slots;
    if (n_threads < 1)
        n_threads = 1;
    PackJob jobs[MAX_THREADS];
    for (int32_t t = 0; t < n_threads; t++)
        jobs[t] = (PackJob){images, out, division, max_rows, tile_h, img_h,
                            img_w, tiles_y, slots * t / n_threads,
                            slots * (t + 1) / n_threads};
    pthread_t threads[MAX_THREADS];
    int started[MAX_THREADS] = {0};
    for (int32_t t = 1; t < n_threads; t++)
        started[t] = pthread_create(&threads[t], NULL, pack_worker,
                                    &jobs[t]) == 0;
    for (int32_t t = 0; t < n_threads; t++)
        if (!started[t])
            pack_worker(&jobs[t]);
    for (int32_t t = 1; t < n_threads; t++)
        if (started[t])
            pthread_join(threads[t], NULL);
    return 0;
}
